"""The port's dictionary pretraining (``engine.make_pretrainer``) against
the JAX package's from the same initial shared state: testdata/mini.dic
(english.dic's first 128 lines, LF -> space as the runners replay it) at
small widths in 128-byte blocks, where the stream pads to 640 bytes, with
WRTW=1 routed as the runner routes it.  The portable profile must match
leaf for leaf; the fast profile's integer leaves exactly (packed slot
fields within one rounding step) and its float leaves within FLOAT_TOL,
the one-step tolerance of ``torch_parity.step_parity`` (the f32 sums run
640 steps in another order; the largest gap measured is 3.5e-6, in the
LSTM's weights).  The match region of ``aux_tbl`` is zeroed after the
replay."""

import jax
import numpy as np
import pytest
import torch

from cmix_tpu import engine as je
from cmix_tpu_torch import convert
from cmix_tpu_torch import engine as E
from torch_parity import _fields_close, _flat, jax_gates  # noqa: F401

KW = dict(block_size=128, seg_size=128, tbits=12, mbits=12, ibits=10,
          pbits=12, lstm_hidden=32, lstm_horizon=4, dmc_nodes=4096)
FLOAT_TOL = 2e-5


def dict_stream():
    with open("testdata/mini.dic", "rb") as f:
        return np.frombuffer(f.read().replace(b"\n", b" "), np.uint8)


def pretrain_both(env, kw, data):
    """(JAX package's pretrained state, the port's) as numpy trees in the
    JAX package's layout, both from the JAX package's init_shared."""
    jcfg = je.EngineConfig(**kw)
    sh0 = jax.device_get(je.init_shared(jcfg))
    ref = jax.device_get(je.make_pretrainer(jcfg)(je.init_shared(jcfg),
                                                  data))
    g = E.make_gates(env)
    assert g.blob() == je.gates_blob()
    sh_t = convert.from_jax_state(sh0, {}, {}, device="cpu")[0]
    out = E.make_pretrainer(E.EngineConfig(**kw), g, torch.device("cpu"))(
        sh_t, data)
    return g, _flat(ref), _flat(convert.to_numpy(out, {}, {})[0]), out


def check_pretrained(g, ref, got, out, cfg):
    assert set(got) == set(ref)
    for k, r in ref.items():
        x = got[k].reshape(r.shape)
        if g.port:
            assert np.array_equal(x, r), k
        elif r.dtype.kind == "f":
            np.testing.assert_allclose(x, r, atol=FLOAT_TOL, rtol=0,
                                       err_msg=k)
        else:
            _fields_close(k, x, r)
    # the match region zeroed, the indirect-hash region kept
    mlen = 2 * g.n_match * (1 << cfg.mbits)
    aux = out["aux_tbl"]
    assert not aux[:mlen].any() and aux[mlen:].any()


@pytest.mark.parametrize("profile", ["fast", "port"])
def test_pretrainer_matches_jax_at_block_128(profile, jax_gates):
    env = {"WRTW": 1, **({"PORT": 1} if profile == "port" else {})}
    jax_gates(env)
    data = dict_stream()
    assert len(data) == 600                 # padded to 5 segments of 128
    g, ref, got, out = pretrain_both(env, KW, data)
    check_pretrained(g, ref, got, out, E.EngineConfig(**KW))
