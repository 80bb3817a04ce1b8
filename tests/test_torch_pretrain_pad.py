"""The pretraining stream's padding and positions against the JAX
package's.  The replay's segment is min(PRETRAIN_SEG, block): at a block of
4096 bytes or more mini.dic's 600 bytes pad to 4096 steps (at 128-byte
blocks, tests/test_torch_pretrain.py, to 640).  The portable profile at
tiny widths at block 4096, every leaf exact against the JAX package's
pretrainer; and, with the byte step stubbed out in both packages, the
(byte, position) sequence each replay feeds the model at blocks of 16 to
65536, english.dic at the CLI's 64 KiB blocks included (81,920 steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu import engine as je
from cmix_tpu_torch import engine as E
from test_torch_pretrain import check_pretrained, dict_stream, pretrain_both
from torch_parity import jax_gates  # noqa: F401

KW = dict(block_size=4096, seg_size=4096, tbits=10, mbits=10, ibits=8,
          pbits=10, lstm_hidden=8, lstm_horizon=2, dmc_nodes=4096)


def test_pretrainer_pads_to_4096_at_block_4096(jax_gates):
    env = {"PORT": 1, "WRTW": 1}
    jax_gates(env)
    assert E.EngineConfig(**KW).seg_size == E.PRETRAIN_SEG == 4096
    g, ref, got, out = pretrain_both(env, KW, dict_stream())
    check_pretrained(g, ref, got, out, E.EngineConfig(**KW))


def _replayed_by_jax(cfg, data, monkeypatch):
    """(bytes, positions) the JAX package's pretrainer feeds its segment
    function, which is stubbed out (and run without jit)."""
    seen = []

    def make_segment_fn(pcfg):
        def segment(sh, pb, cd, t0, inp, comp, mode):
            seen.append((np.asarray(inp)[:, 0].copy(),
                         int(t0) + np.arange(pcfg.seg_size)))
            return sh, pb, cd, None, None
        return segment
    monkeypatch.setattr(je, "make_segment_fn", make_segment_fn)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    mlen = 2 * len(je.MATCH_ORDERS) * (1 << cfg.mbits)
    sh = je.make_pretrainer(cfg)({"aux_tbl": jnp.ones(mlen + 8, jnp.uint32)},
                                 data)
    return (np.concatenate([b for b, _ in seen]),
            np.concatenate([t for _, t in seen]), np.asarray(sh["aux_tbl"]))


def _replayed_by_port(cfg, data, monkeypatch):
    seen = []

    def make_byte_step(pcfg, g, device, comm=None):
        def step(sh, pb, cd, comp, inp_b, t, mode):
            seen.append((int(inp_b[0]), t))
            return sh, pb, cd, None, None
        return step
    monkeypatch.setattr(E, "make_byte_step", make_byte_step)
    g = E.make_gates({})
    mlen = 2 * g.n_match * (1 << cfg.mbits)
    sh = E.make_pretrainer(cfg, g, torch.device("cpu"))(
        {"aux_tbl": torch.ones(mlen + 8, dtype=torch.int32)}, data)
    seq = np.array(seen, dtype=np.int64).reshape(-1, 2)
    return seq[:, 0], seq[:, 1], sh["aux_tbl"].numpy()


@pytest.mark.parametrize("block,dic,steps", [
    (16, "testdata/mini.dic", 608), (128, "testdata/mini.dic", 640),
    (4096, "testdata/mini.dic", 4096), (8192, "testdata/mini.dic", 4096),
    (65536, "cmix_tpu_torch/data/english.dic", 81920)])
def test_replay_order_matches_jax(block, dic, steps, monkeypatch):
    with open(dic, "rb") as f:
        data = np.frombuffer(f.read().replace(b"\n", b" "), np.uint8)
    kw = dict(block_size=block, tbits=10, mbits=10, ibits=8, pbits=10,
              lstm_hidden=0, dmc_nodes=0)
    ref = _replayed_by_jax(je.EngineConfig(**kw), data, monkeypatch)
    got = _replayed_by_port(E.EngineConfig(**kw), data, monkeypatch)
    assert len(got[0]) == len(ref[0]) == steps
    for a, b in zip(got, ref):
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))
    assert np.array_equal(got[0][:len(data)], data)
    assert (got[0][len(data):] == 32).all() and got[1].max() < block
    assert not got[2][:-8].any() and got[2][-8:].all()
