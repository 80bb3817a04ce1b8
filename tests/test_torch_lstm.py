"""Port's LSTM byte mixer vs the JAX package: the numpy replica of the
``jax.random.normal`` init, and one online training step from identical
state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmix_tpu.mixer import lstm as jlstm
from cmix_tpu_torch import convert
from cmix_tpu_torch.mixer import lstm

CPU = torch.device("cpu")
# largest gap the numpy threefry + erf_inv replica shows against
# jax.random.normal (XLA evaluates erf_inv's polynomial with its own
# fused multiply-adds); the draws are otherwise bit-identical
MAX_ULP = 3


def _ulp_gap(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("hidden", [32, 256])
def test_init_matches_jax_random_normal(hidden):
    pj = jax.device_get(jlstm.init_lstm_shared(
        jlstm.LstmConfig(hidden=hidden))["params"])
    pt = lstm.init_lstm_shared(lstm.LstmConfig(hidden=hidden), CPU)
    assert set(pt["params"]) == set(pj)
    gaps = {k: _ulp_gap(pj[k], pt["params"][k].numpy()) for k in pj}
    assert max(gaps.values()) <= MAX_ULP, gaps
    assert gaps["b"] == gaps["bo"] == 0
    assert pt["opt"]["step"] == 0


def test_threefry_split_matches_jax():
    key = jax.random.PRNGKey(0x1234)
    assert np.array_equal(lstm.prng_key(0x1234), np.asarray(
        jax.random.key_data(key)))
    assert np.array_equal(lstm.split(lstm.prng_key(0x1234), 4),
                          np.asarray(jax.random.key_data(
                              jax.random.split(key, 4))))


@pytest.mark.parametrize("horizon", [4, 8])
def test_byte_update_matches_from_identical_state(horizon):
    """One Adam step over a ``horizon``-byte BPTT window from identical
    state (8 is the CLI's horizon above 256 KiB; the 12 warm-up bytes fill
    either ring).  f32 tolerances: the GEMM sum order differs from XLA's
    (CPU), so activations agree to ~1e-6; Adam's normalised step magnifies
    tiny gradient differences where the second moment is small."""
    B = 4
    cj = jlstm.LstmConfig(hidden=32, horizon=horizon)
    ct = lstm.LstmConfig(hidden=32, horizon=horizon)
    sh = jlstm.init_lstm_shared(cj)
    pb = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (B,) + (1,)
                                                   * x.ndim),
                                jlstm.init_lstm_perblock(cj))
    upd = jax.jit(lambda s, p, b: jlstm.lstm_shared_byte_update(cj, s, p, b))
    text = np.frombuffer(open("testdata/text10k.raw", "rb").read()[:64],
                         np.uint8).reshape(16, B)
    for row in text[:12]:
        sh, pb = upd(sh, pb, jnp.asarray(row.astype(np.int32)))
    st, pt, _ = convert.from_jax_state({"lstm": jax.device_get(sh)},
                                       {"lstm": jax.device_get(pb)}, {},
                                       device="cpu")
    byte = text[12].astype(np.int64)
    sh2, pb2 = upd(sh, pb, jnp.asarray(byte.astype(np.int32)))
    with torch.no_grad():
        st2, pt2 = lstm.lstm_shared_byte_update(ct, st["lstm"], pt["lstm"],
                                                torch.as_tensor(byte))
    sh2, pb2 = jax.device_get((sh2, pb2))
    assert st2["opt"]["step"] == int(sh2["opt"]["step"]) == 13
    for k in pb2:
        tol = 0.05 if k == "qcum" else 1e-5          # qcum is scaled 2^16
        if k == "ring":
            assert np.array_equal(pt2[k].numpy(), pb2[k])
        else:
            np.testing.assert_allclose(pt2[k].numpy(), pb2[k], atol=tol,
                                       rtol=0, err_msg=k)
    for group in ("params", "m", "v"):
        src = sh2["params"] if group == "params" else sh2["opt"][group]
        got = st2["params"] if group == "params" else st2["opt"][group]
        for k in src:
            np.testing.assert_allclose(got[k].numpy(), src[k], atol=2e-5,
                                       rtol=0, err_msg=f"{group}.{k}")
