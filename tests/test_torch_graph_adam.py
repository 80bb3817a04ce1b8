"""The float LSTM's Adam step as device state (what a captured byte step
replays): the step count is a 0-d int32 tensor, as in the JAX package,
and the bias corrections come from a table of numpy's float32 pow read at
the step clamped to ``lstm.BC_STEPS``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu.mixer import lstm as jlstm
from cmix_tpu_torch import convert
from cmix_tpu_torch.mixer import lstm

CPU = torch.device("cpu")


def test_bias_table_is_numpy_float32_pow_and_clamps_exactly():
    cfg = lstm.LstmConfig()
    f32 = np.float32
    K = lstm.BC_STEPS
    steps = torch.arange(1, K + 101, dtype=torch.int32)
    got = [lstm.bias_corrections(cfg, s) for s in steps[[0, 1, 163, 164, K - 2,
                                                         K - 1, K, K + 99]]]
    tbl = lstm.bias_table(cfg, CPU).numpy()
    assert tbl.shape == (K, 2) and tbl.dtype == np.float32
    for t in range(1, K + 101):
        want = [f32(1) - f32(b) ** f32(t) for b in (cfg.beta1, cfg.beta2)]
        row = tbl[min(t, K) - 1]
        assert row[0] == want[0] and row[1] == want[1], t
    for (b1, b2), t in zip(got, (1, 2, 164, 165, K - 1, K, K + 1, K + 100)):
        assert b1.dtype == b2.dtype == torch.float32 and b1.dim() == 0
        assert float(b1) == f32(1) - f32(cfg.beta1) ** f32(t), t
        assert float(b2) == f32(1) - f32(cfg.beta2) ** f32(t), t
    # K is the first step at which both corrections round to 1.0f
    assert tbl[K - 1].tolist() == [1.0, 1.0] and tbl[K - 2, 1] < 1.0
    assert tbl[164, 0] == 1.0 and tbl[163, 0] < 1.0


def test_step_is_a_device_int32_leaf_like_the_jax_packages():
    cfg = lstm.LstmConfig(hidden=16, horizon=4)
    sh = lstm.init_lstm_shared(cfg, CPU)
    step = sh["opt"]["step"]
    assert step.dtype == torch.int32 and step.dim() == 0 and int(step) == 0
    jsh = jax.device_get(jlstm.init_lstm_shared(jlstm.LstmConfig(
        hidden=16, horizon=4)))
    jsh["opt"]["step"] = np.asarray(41, np.int32)
    st, _, _ = convert.from_jax_state({"lstm": jsh}, {}, {}, device="cpu")
    got = st["lstm"]["opt"]["step"]
    assert got.dtype == torch.int32 and int(got) == 41
    back = convert.to_numpy(st, {}, {})[0]["lstm"]["opt"]["step"]
    assert back.dtype == np.int32 and int(back) == 41
    pb = lstm.init_lstm_perblock(cfg, 2, CPU)
    with torch.no_grad():
        sh2, _ = lstm.lstm_shared_byte_update(cfg, sh, pb,
                                              torch.tensor([65, 66]))
    assert sh2["opt"]["step"].dtype == torch.int32
    assert int(sh2["opt"]["step"]) == 1


def test_late_steps_match_the_jax_update():
    """Past the clamp (step K+5) the update still follows the JAX
    package's, whose jnp.power rounds the corrections to 1.0f there."""
    B = 2
    cj = jlstm.LstmConfig(hidden=16, horizon=4)
    ct = lstm.LstmConfig(hidden=16, horizon=4)
    sh = jlstm.init_lstm_shared(cj)
    sh["opt"]["step"] = jnp.asarray(lstm.BC_STEPS + 4, jnp.int32)
    pb = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (B,) + (1,)
                                                   * x.ndim),
                                jlstm.init_lstm_perblock(cj))
    byte = np.array([101, 32])
    st, pt, _ = convert.from_jax_state({"lstm": jax.device_get(sh)},
                                       {"lstm": jax.device_get(pb)}, {},
                                       device="cpu")
    sh2, _ = jax.jit(lambda s, p, b: jlstm.lstm_shared_byte_update(
        cj, s, p, b))(sh, pb, jnp.asarray(byte.astype(np.int32)))
    with torch.no_grad():
        st2, _ = lstm.lstm_shared_byte_update(ct, st["lstm"], pt["lstm"],
                                              torch.as_tensor(byte))
    sh2 = jax.device_get(sh2)
    assert int(st2["opt"]["step"]) == int(sh2["opt"]["step"])
    for k in sh2["params"]:
        np.testing.assert_allclose(st2["params"][k].numpy(),
                                   sh2["params"][k], atol=2e-5, rtol=0,
                                   err_msg=k)
