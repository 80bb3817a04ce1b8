"""The plain version of the port's second DMC kernel (the prediction-only
walk, ``dmc.counts_walk``) against the JAX package: its XLA walk at
L=8/7/6 and its Pallas kernel ``_counts_pallas`` in interpret mode at L=8,
with a pool that is not a multiple of 1024 too (the JAX wrapper pads it).
Machines are grown by real predict/plan steps.  Integer data: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmix_tpu.models import dmc as jdmc
from cmix_tpu_torch.models import dmc
from torch_parity import (B, jax_dmc_state, jax_levels,  # noqa: F401
                          dmc_to_port, u32_np)


def _applied(pb):
    """The JAX machine with its pending descriptors applied (the walk
    kernel reads tables with nothing pending)."""
    nxt, cnt = jdmc._apply_xla(pb["dmc_nxt"], pb["dmc_cnt"], pb)
    return nxt, cnt, pb["dmc_cur"]


@pytest.mark.parametrize("levels", [8, 7, 6])
def test_counts_plain_matches_xla_walk(levels, jax_levels):  # noqa: F811
    jax_levels(levels)
    nxt, cnt, cur = _applied(jax_dmc_state(levels + 10, 60))
    ref = u32_np(jdmc._counts_xla(nxt, cnt, cur))            # (B, 2^L)
    pt = dmc_to_port({"dmc_nxt": nxt, "dmc_cnt": cnt, "dmc_cur": cur})
    got = dmc.counts_walk(pt["dmc_nxt"], pt["dmc_cnt"], pt["dmc_cur"],
                          levels)
    assert got.shape == (B, 256) and got.dtype == torch.int32
    assert np.array_equal(u32_np(got[:, :1 << levels]), ref)
    assert not got[:, 1 << levels:].any()
    assert (got[:, :1 << levels] != dmc.INIT_U | (dmc.INIT_U << 16)).any()


@pytest.mark.parametrize("n_nodes", [5120, 4600])
def test_counts_plain_matches_pallas_interpret(n_nodes):
    """The TPU kernel itself, interpreted, on two of the blocks; 4600 is
    padded to 5120 by ``_counts_pallas`` (node ids never reach the pad)."""
    pj = {k: jnp.tile(v[None], (2,) + (1,) * v.ndim)
          for k, v in jdmc.init_dmc_perblock(n_nodes).items()}
    rng = np.random.RandomState(n_nodes)
    for _ in range(50):
        upd, walk = jdmc.predict_step(pj)
        pj.update(upd)
        pj.update(jdmc.plan_step({k: pj[k] for k in jdmc.DMC_KEYS}, walk,
                                 jnp.asarray(rng.randint(0, 256, size=2))))
    nxt, cnt, cur = _applied(pj)
    ref = u32_np(jdmc._counts_pallas(nxt.reshape(2, -1), cnt.reshape(2, -1),
                                     cur, interpret=True))
    pt = dmc_to_port({"dmc_nxt": nxt, "dmc_cnt": cnt, "dmc_cur": cur})
    got = dmc.counts_walk(pt["dmc_nxt"], pt["dmc_cnt"], pt["dmc_cur"], 8)
    assert np.array_equal(u32_np(got), ref)


def test_counts_walk_rejects_bad_levels():
    pb = dmc.init_dmc_perblock(4096, 2, torch.device("cpu"))
    with pytest.raises(ValueError):
        dmc.counts_walk(pb["dmc_nxt"], pb["dmc_cnt"], pb["dmc_cur"], 9)
