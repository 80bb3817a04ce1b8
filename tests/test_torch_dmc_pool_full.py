"""The DMC model through a whole bench block: the port's plain DMC
(apply+walk, ``plan_step``) against the JAX package's, step by step over
16384 bytes of 4 of bench4m.raw's 16 KiB blocks (0, 64, 128, 192) at the
bench's pool (``BDMC_N``, 16384 nodes) and walk depth (``BDMC_L``, 7).
Each lane's pool fills before its block ends, after which every clone is
refused (the fused kernel's clone pointers are -1) for the rest of the
block; both machines stay equal.  Exact: all DMC arithmetic is integer.
One JAX compile."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cmix_tpu.models import dmc as jdmc
from cmix_tpu_torch import bench
from cmix_tpu_torch.models import dmc
from torch_parity import dmc_to_port, jax_levels, u32_np  # noqa: F401

CHECK_EVERY = 2048


def test_a_full_pool_stays_in_step_with_jax(jax_levels):  # noqa: F811
    cfg, gates = bench.bench_config({})
    levels, pool, steps = gates["DMC_LEVELS"], cfg.dmc_nodes, cfg.block_size
    jax_levels(levels)
    lanes = np.frombuffer(bench.corpus(), np.uint8).reshape(256, -1)[::64]
    b = lanes.shape[0]
    pj = {k: jnp.tile(v[None], (b,) + (1,) * v.ndim)
          for k, v in jdmc.init_dmc_perblock(pool).items()}
    pt = dmc_to_port(pj)

    @jax.jit
    def jax_step(pb, byte):
        upd, walk = jdmc.predict_step(pb)
        pb = dict(pb, **upd)
        return dict(pb, **jdmc.plan_step({k: pb[k] for k in jdmc.DMC_KEYS},
                                         walk, byte))

    full = np.full(b, -1)
    for step in range(steps):
        byte = lanes[:, step].astype(np.int64)
        pj = jax_step(pj, jnp.asarray(byte.astype(np.int32)))
        upd, walk = dmc.predict_step(pt, levels)
        pt.update(upd)
        pt.update(dmc.plan_step(pt, walk, torch.as_tensor(byte), levels))
        top = pt["dmc_top"].numpy()
        full = np.where((full < 0) & (top == pool), step, full)
        if step % CHECK_EVERY == CHECK_EVERY - 1:
            for k in dmc.DMC_STATE_KEYS:
                assert np.array_equal(u32_np(pt[k]), u32_np(pj[k])), (step,
                                                                       k)
    # the step at which each lane's pool filled: deterministic integer
    # work on fixed data (block 128's fills 117 steps before its end)
    assert full.tolist() == [9495, 10311, 16267, 9394]
