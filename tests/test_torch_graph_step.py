"""The callable a CUDA graph captures (``engine.make_static_step``), run
eagerly on the CPU: the byte step on static buffers equals the plain step
on every leaf, and no static buffer changes its storage."""

import numpy as np
import pytest
import torch

import torch_parity
from cmix_tpu_torch import engine as E
from cmix_tpu_torch.utils.checkpoint import _leaves, clone_state
from cmix_tpu_torch.utils.profiling import GATE_SETS

CPU = torch.device("cpu")
B = 3


def _group(cfg, g, off=0):
    with open("testdata/text100k.raw", "rb") as f:
        raw = f.read()[off:off + B * cfg.block_size]
    data = np.frombuffer(raw, np.uint8).reshape(B, cfg.block_size)
    return (E.init_shared(cfg, g, CPU), E.init_perblock(cfg, g, B, CPU),
            E.init_coder(B, CPU),
            torch.zeros((B, cfg.comp_size), dtype=torch.uint8),
            torch.zeros(B, dtype=torch.int64),
            torch.as_tensor(data.T.copy()))


# the last two: every off-by-default mechanism of each profile, whose new
# leaves (w_sse, sbank_c, jval, jval2) the body writes back as well
@pytest.mark.parametrize("env", [{}, {"PORT": 1}, GATE_SETS["gated"],
                                 GATE_SETS["gated-portable"]])
def test_static_step_equals_the_plain_step(env):
    cfg = E.EngineConfig(**dict(torch_parity.RUNNER_KW, seg_size=16))
    g = E.make_gates(env)
    sh, pb, cd, comp, mode, inp = _group(cfg, g)
    S = cfg.seg_size
    st = dict(sh=clone_state(sh), pb=clone_state(pb), cd=clone_state(cd),
              comp=comp, mode=mode, inp=inp[:S].clone(),
              e32=torch.zeros((S, B, 8), dtype=torch.int64),
              c32=torch.zeros((S, B), dtype=torch.int64),
              t=torch.zeros((), dtype=torch.int64))
    ptrs = {n: v.data_ptr() for n, v in _leaves(st)}
    body = E.make_static_step(cfg, g, CPU)
    step = E.make_byte_step(cfg, g, CPU)
    with torch.no_grad():
        for s in range(20):
            if s == S:                   # the next segment's rows
                st["inp"].copy_(inp[S:2 * S])
            body(st)
            sh, pb, cd, e32, c32 = step(sh, pb, cd, comp, inp[s],
                                        torch.tensor(s), mode)
            assert torch.equal(st["e32"][s % S], e32)
            assert torch.equal(st["c32"][s % S], c32)
    assert int(st["t"]) == 20
    want = dict(_leaves(dict(sh=sh, pb=pb, cd=cd)))
    got = dict(_leaves(st))
    assert set(want) <= set(got) and len(want) > 100
    for name, x in want.items():
        assert x.dtype == got[name].dtype and torch.equal(got[name], x), name
    assert {n: v.data_ptr() for n, v in _leaves(st)} == ptrs


def test_segments_copy_a_later_group_in_and_wrap_t():
    """The eager segment runner (the CPU's path) and the static body agree
    over whole groups: t wraps at the block's end, a second group starts
    from its own state."""
    cfg = E.EngineConfig(**dict(torch_parity.RUNNER_KW, block_size=32,
                                seg_size=16))
    g = E.make_gates({})
    seg = E.make_segment_fn(cfg, g, CPU)
    assert not seg.graph and not seg.ready
    body = E.make_static_step(cfg, g, CPU)
    with torch.no_grad():
        for off in (0, 7000):
            sh, pb, cd, comp, mode, inp = _group(cfg, g, off)
            st = dict(sh=clone_state(sh), pb=clone_state(pb),
                      cd=clone_state(cd), comp=comp, mode=mode,
                      inp=torch.zeros((16, B), dtype=torch.uint8),
                      e32=torch.zeros((16, B, 8), dtype=torch.int64),
                      c32=torch.zeros((16, B), dtype=torch.int64),
                      t=torch.zeros((), dtype=torch.int64))
            seg.start(sh, pb, cd, comp, mode)
            for lo in (0, 16):
                e32, c32 = seg.run(inp[lo:lo + 16])
                st["inp"].copy_(inp[lo:lo + 16])
                for _ in range(16):
                    body(st)
                assert torch.equal(e32, st["e32"])
                assert torch.equal(c32, st["c32"])
            assert int(st["t"]) == 0 and seg.st["t"] == 0
            want = dict(_leaves(dict(zip(("sh", "pb", "cd"),
                                         seg.state()))))
            got = dict(_leaves(st))
            for name, x in want.items():
                assert torch.equal(got[name], x), name


def test_a_step_that_changes_the_state_keys_is_refused():
    cfg = E.EngineConfig(**torch_parity.RUNNER_KW)
    g = E.make_gates({})
    sh, pb, cd, comp, mode, inp = _group(cfg, g)
    new = dict(pb, extra=torch.zeros(1))
    with pytest.raises(RuntimeError, match="keys"):
        E._rebound(pb, new)
    assert E._rebound(pb, dict(pb)) == []
