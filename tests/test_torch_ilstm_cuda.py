"""The portable LSTM's update chain (``csrc/ilstm_update.cu``) on the card
against its plain version (marker ``cuda``; each test skips without a
card).  On a machine with a card but without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_ilstm_cuda.py

Imports nothing of JAX: the plain version, which the CPU tests hold
against the JAX package, is the reference here.
"""

import pytest
import torch

import chip_smoke
from cmix_tpu_torch import engine as E
from cmix_tpu_torch.mixer import ilstm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return E.resolve_device("cuda")


@pytest.mark.parametrize("kind", ["text", "edge"])
@pytest.mark.parametrize("opt", list(chip_smoke.ILSTM_OPTS))
@pytest.mark.parametrize("shape", chip_smoke.ILSTM_SHAPES,
                         ids=lambda s: "B%d-H%d-W%d" % s)
def test_chain_matches_plain_version(gpu, shape, opt, kind):
    """Every leaf of the returned sh and pb exact over 16 consecutive
    updates from the init state, and 3 launches an update."""
    n0 = ilstm.ilstm_shared_byte_update.launches
    bad = chip_smoke.ilstm_vs_plain(*shape, opt, kind,
                                    chip_smoke.ILSTM_STEPS, gpu)
    assert bad == {}
    assert (ilstm.ilstm_shared_byte_update.launches
            == n0 + ilstm.LAUNCHES * chip_smoke.ILSTM_STEPS)


def test_edge_inputs_saturate_and_clip(gpu):
    """The edge inputs reach the clamps the chain must keep: pre-
    activations past +-PRE_CLIP in the first cell, and an update that
    moves weights held at their clips without leaving them."""
    cfg, sh, pb, seq = chip_smoke.ilstm_inputs(5, 8, 12, "sgd", "edge", 2,
                                               gpu)
    pre = (sh["wx"][seq[0]] + ilstm._dot16("bh,hk->bk", pb["h0"], sh["wh"])
           + sh["b"][None])
    assert (pre.abs() > ilstm.PRE_CLIP).any()
    new, _ = ilstm.ilstm_shared_byte_update(cfg, sh, pb, seq[0])
    assert (new["wh"].abs() <= ilstm.W_CLIP).all()
    assert (new["wh"] != sh["wh"]).any()


def test_wrapper_rejects_bad_operands(gpu):
    cfg, sh, pb, seq = chip_smoke.ilstm_inputs(3, 16, 4, "adam", "text", 1,
                                               gpu)
    byte = seq[0]
    n0 = ilstm.ilstm_shared_byte_update.launches
    bad = [
        (dict(sh, wh=sh["wh"].long()), pb, byte),          # dtype
        (dict(sh, wo=sh["wo"][:, :128]), pb, byte),        # shape
        (dict(sh, wx=sh["wx"].t().contiguous().t()), pb, byte),  # strides
        ({k: v for k, v in sh.items() if k != "m_wx"}, pb, byte),  # Adam
        (sh, dict(pb, ring=pb["ring"][:, :2]), byte),      # horizon
        (sh, dict(pb, h=pb["h"].cpu()), byte),             # device
        (sh, pb, byte.cpu()),
        (sh, pb, byte.float()),
        (sh, pb, byte[:2]),                                # lanes
    ]
    for s, p, b in bad:
        with pytest.raises(ValueError):
            ilstm.ilstm_shared_byte_update(cfg, s, p, b)
    assert ilstm.ilstm_shared_byte_update.launches == n0
