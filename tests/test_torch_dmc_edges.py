"""The port's plain DMC apply + walk against the JAX package's XLA apply +
walk on descriptor sets that real ``plan_step``s rarely produce
(``chip_smoke.dmc_edge_cases``, the sets the card's kernels are held to),
at L = 8, 7, 4, 1.  Integer data: exact."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmix_tpu.models import dmc as jdmc
from cmix_tpu_torch import convert
from cmix_tpu_torch.models import dmc
from torch_parity import jax_levels, u32_np  # noqa: F401

B, N = 4, 32768                 # > chip_smoke.TABLED_NODES: twins differ
LEVELS = [8, 7, 4, 1]
_DESC = (("dmc_uX", "dmc_uXC"), ("dmc_uS", "dmc_uSW"), ("dmc_uU", "dmc_uUW"))


@functools.lru_cache(maxsize=None)
def _cases(levels):
    """(a grown machine with real pending descriptors, its edge sets)."""
    pb = chip_smoke.dmc_descriptors(B, N, levels, 30, "cpu")
    return pb, chip_smoke.dmc_edge_cases(pb, levels, seed=levels)


def _apply_walk(st, levels):
    nxt, cnt = st["dmc_nxt"].clone(), st["dmc_cnt"].clone()
    dmc._apply_plain(nxt, cnt, *(st[k] for k in dmc.DMC_UPD_KEYS))
    return (nxt, cnt) + dmc._walk_plain(nxt, cnt, st["dmc_cur"], levels)


@pytest.mark.parametrize("case", chip_smoke.EDGE_CASES)
@pytest.mark.parametrize("levels", LEVELS)
def test_edge_case_matches_xla(levels, case, jax_levels):  # noqa: F811
    jax_levels(levels)
    st = _cases(levels)[1][case]
    got = _apply_walk(st, levels)
    js = {k: jnp.asarray(v)
          for k, v in convert.to_numpy({}, st, {})[1].items()}
    nxt, cnt = jdmc._apply_xla(js["dmc_nxt"], js["dmc_cnt"], js)
    ref = (nxt, cnt) + jdmc._walk_xla(nxt, cnt, js["dmc_cur"])
    assert got[2].shape == (B, 1 << levels)
    for g, r in zip(got, ref):
        assert np.array_equal(u32_np(g), u32_np(r))


@pytest.mark.parametrize("levels", LEVELS)
def test_edge_cases_are_what_they_say(levels):
    pb, cases = _cases(levels)
    assert tuple(cases) == chip_smoke.EDGE_CASES
    for st in cases.values():
        for idx, word in _DESC:         # plan_step's guarantees hold
            i, w = st[idx], st[word]
            dup = (i[:, :, None] == i[:, None, :]) & (i[:, :, None] >= 0)
            assert ((w[:, :, None] == w[:, None, :]) | ~dup).all()
            assert (i < N).all()
        for word in ("dmc_uSW", "dmc_uUW"):
            w = st[word].long() & 0xFFFFFFFF
            assert ((w & 0xFFFF) < N).all() and ((w >> 16) < N).all()
    assert all((cases["none"][i] < 0).all() for i, _ in _DESC)
    assert (cases["ux_dups"]["dmc_uX"] >= 0).all()
    cp = cases["clone_and_path"]
    assert ((cp["dmc_uS"][:, :, None] == cp["dmc_uU"][:, None, :])
            & (cp["dmc_uSW"][:, :, None] != cp["dmc_uUW"][:, None, :])).any()
    leaves = dmc._walk_plain(pb["dmc_nxt"], pb["dmc_cnt"], pb["dmc_cur"],
                             levels)[1][:, 1 << (levels - 1):]
    lx = cases["leaf_count"]["dmc_uX"]
    assert (lx[:, :, None] == leaves[:, None, :]).any(dim=2).all()
    ends = cases["ids_0_and_last"]
    assert (ends["dmc_cur"] == N - 1).all()
    assert ((ends["dmc_uX"] == 0).any(1) & (ends["dmc_uX"] == N - 1).any(1)
            ).all()
    sh = cases["twins"]
    for idx in ("dmc_uX", "dmc_uU", "dmc_uS"):  # ids TABLED_NODES apart
        i = sh[idx].long()
        pair = ((i[:, :, None] - i[:, None, :]) % N
                == chip_smoke.TABLED_NODES)
        assert (pair & (i[:, :, None] >= 0) & (i[:, None, :] >= 0)
                ).any(dim=(1, 2)).all(), idx
    assert ((sh["dmc_uS"][:, :, None] == sh["dmc_uU"][:, None, :])
            & (sh["dmc_uS"][:, :, None] >= 0)).any(dim=(1, 2)).all()
    if levels >= 2:                     # the written words move the walk
        base = dmc._walk_plain(pb["dmc_nxt"], pb["dmc_cnt"], pb["dmc_cur"],
                               levels)[1]
        for name in ("on_path", "clone_and_path"):
            assert not torch.equal(_apply_walk(cases[name], levels)[3],
                                   base), name
