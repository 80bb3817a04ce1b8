"""Tests of the port that need an NVIDIA GPU (marker ``cuda``; each skips
without a card).  On a machine with a card but without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Imports nothing of JAX, so it runs where only the port is installed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.models import dmc

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return E.resolve_device("cuda")


@pytest.mark.parametrize("levels", range(1, 9))
def test_dmc_kernel_matches_plain_version(gpu, levels):
    B, N = 16, 4096
    pb = dmc.init_dmc_perblock(N, B, gpu)
    rng = np.random.default_rng(levels)
    for _ in range(40):
        dmc._apply_plain(pb["dmc_nxt"], pb["dmc_cnt"],
                         *(pb[k] for k in dmc.DMC_UPD_KEYS))
        cw, vis, wn = dmc._walk_plain(pb["dmc_nxt"], pb["dmc_cnt"],
                                      pb["dmc_cur"], levels)
        pb.update(dmc.plan_step(pb, {"cw": cw, "vis": vis, "wn": wn},
                                torch.as_tensor(rng.integers(0, 256, B),
                                                device=gpu), levels))
    args = [pb["dmc_cur"]] + [pb[k] for k in dmc.DMC_UPD_KEYS]
    nk, ck = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
    n0 = dmc.fused_apply_walk.launches
    got = dmc.fused_apply_walk(nk, ck, *args, levels)
    assert dmc.fused_apply_walk.launches == n0 + 1
    npl, cpl = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
    dmc._apply_plain(npl, cpl, *args[1:])
    want = dmc._walk_plain(npl, cpl, args[0], levels)
    torch.cuda.synchronize()
    for a, b in [(nk, npl), (ck, cpl)] + list(zip(got, want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("levels", range(1, 9))
def test_counts_kernel_matches_plain_version(gpu, levels):
    B, N = 16, 4096
    pb = dmc.init_dmc_perblock(N, B, gpu)
    rng = np.random.default_rng(10 + levels)
    for _ in range(40):
        upd, walk = dmc.predict_step(pb, levels)
        pb.update(upd)
        pb.update(dmc.plan_step(pb, walk, torch.as_tensor(
            rng.integers(0, 256, B), device=gpu), levels))
    nxt, cnt, cur = pb["dmc_nxt"], pb["dmc_cnt"], pb["dmc_cur"]
    n0 = dmc.counts_walk.launches
    got = dmc.counts_walk(nxt, cnt, cur, levels)
    assert dmc.counts_walk.launches == n0 + 1
    want = dmc._counts_plain(nxt, cnt, cur, levels)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[:, 1 << levels:].any()


@pytest.mark.parametrize("levels", range(1, 9))
def test_kernels_match_plain_versions_on_edge_cases(gpu, levels):
    """Both kernels on chip_smoke's edge-case descriptor sets (forwarded
    writes on the walked path, a clone and a path word on one node, ids 0
    and N-1, twins 16384 apart, ...): bit-exact, tables included
    (kernels_vs_plain raises)."""
    pb = chip_smoke.dmc_descriptors(16, 32768, levels, 30, gpu)
    for name, st in chip_smoke.dmc_edge_cases(pb, levels, levels).items():
        errs = chip_smoke.kernels_vs_plain(st, levels, name)
        assert errs == {"dmc_fused": 0, "dmc_counts": 0}


def test_fused_kernel_at_the_largest_pool(gpu):
    """N=65536, above the fused kernel's tabled pools (it compares with
    every descriptor instead): ids up to N-1 and twins (the edge sets)."""
    pb = chip_smoke.dmc_descriptors(4, 65536, 8, 30, gpu)
    for name, st in {"real flow": pb,
                     **chip_smoke.dmc_edge_cases(pb, 8, 65536)}.items():
        assert chip_smoke.kernels_vs_plain(st, 8, name) == {
            "dmc_fused": 0, "dmc_counts": 0}


def test_kernel_wrapper_rejects_bad_operands(gpu):
    pb = dmc.init_dmc_perblock(4096, 2, gpu)
    args = [pb[k] for k in ("dmc_nxt", "dmc_cnt", "dmc_cur")
            + dmc.DMC_UPD_KEYS]
    with pytest.raises(ValueError):
        dmc.fused_apply_walk(*args[:2], args[2].long(), *args[3:], 8)
    with pytest.raises(ValueError):
        dmc.fused_apply_walk(*args, 9)
    n0 = dmc.fused_apply_walk.launches, dmc.counts_walk.launches
    empty = [a[:0] for a in args]       # a grid of 0 CTAs: the card refuses
    with pytest.raises(RuntimeError):
        dmc.fused_apply_walk(*empty, 8)
    with pytest.raises(RuntimeError):
        dmc.counts_walk(*empty[:3], 8)
    assert (dmc.fused_apply_walk.launches, dmc.counts_walk.launches) == n0


def test_roundtrip_on_gpu_goes_through_the_kernel(gpu):
    cfg = E.EngineConfig(block_size=64, seg_size=64, tbits=12, mbits=12,
                         ibits=10, pbits=12, lstm_hidden=32,
                         lstm_horizon=4, dmc_nodes=4096)
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[:192]
    dmc.fused_apply_walk.launches = 0
    arc = runner.compress(data, cfg, device=gpu)
    assert dmc.fused_apply_walk.launches == 64
    assert runner.decompress(arc, device=gpu) == data
    assert runner.compress(data, cfg, device=gpu) == arc


@pytest.mark.parametrize("gates", [{"PORT": 1}, {"PORT": 1, "ILSTM_ADAM": 1,
                                                   "ILSTM_LRX": 6}])
def test_portable_roundtrip_on_gpu_matches_the_cpu(gpu, gates):
    """PORT=1 on the card: exact round trip through the kernel, and the
    archive byte-identical to the CPU's (the portable contract)."""
    cfg = E.EngineConfig(block_size=64, seg_size=64, tbits=12, mbits=12,
                         ibits=10, pbits=12, lstm_hidden=32,
                         lstm_horizon=4, dmc_nodes=4096)
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[4000:4160]
    kw = dict(max_batch=2, gates=gates)
    dmc.fused_apply_walk.launches = 0
    arc = runner.compress(data, cfg, device=gpu, **kw)
    assert dmc.fused_apply_walk.launches == 128          # two groups
    assert runner.decompress(arc, device=gpu) == data
    assert runner.compress(data, cfg, device="cpu", **kw) == arc
