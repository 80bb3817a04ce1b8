"""One byte step of the port's engine vs the JAX package's, from identical
state (carried across with ``convert.from_jax_state``), for both gate sets
this slice runs: the defaults and the bench speed profile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmix_tpu import engine as je
from cmix_tpu_torch import convert
from cmix_tpu_torch import engine as E

CPU = torch.device("cpu")
B = 4
KW = dict(block_size=512, seg_size=256, tbits=12, mbits=12, ibits=10,
          pbits=12, lstm_hidden=32, dmc_nodes=5120, lstm_horizon=4)
# packed slot words whose fields come from a float quantisation: the
# stretch (st13) and probability (p12) fields may round one step apart
# where the f32 inputs differ in the last place; counts/states are exact
_SLOT_TABLES = ("bank", "d12")
_SBANK = "sbank"


@pytest.fixture
def jax_gates():
    prev = je.gates_blob()
    yield je.update_gates
    je.apply_gates(prev)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _fields_close(name, a, b):
    a, b = a.astype(np.int64), b.astype(np.int64)
    if name.split(".")[-1].startswith(_SLOT_TABLES):
        fields = [(a >> 18, b >> 18, 1), ((a >> 6) & 0xFFF,
                                          (b >> 6) & 0xFFF, 1),
                  (a & 0x3F, b & 0x3F, 0)]
    elif name.split(".")[-1] == _SBANK:
        fields = [(a >> 8, b >> 8, 1), (a & 0xFF, b & 0xFF, 0)]
    else:
        fields = [(a, b, 0)]
    for x, y, tol in fields:
        assert np.abs(x - y).max(initial=0) <= tol, name


@pytest.mark.parametrize("gates", ["default", "bench"])
def test_byte_step_matches_jax_from_identical_state(gates, jax_gates):
    env = E.BENCH_GATES if gates == "bench" else {}
    jax_gates(env)
    g = E.make_gates(env)
    jcfg, cfg = je.EngineConfig(**KW), E.EngineConfig(**KW)
    data = np.frombuffer(open("testdata/text100k.raw", "rb").read()[
        :B * 512], np.uint8).reshape(B, 512)
    tile = lambda x: jnp.tile(x[None], (B,) + (1,) * x.ndim)   # noqa: E731
    sh = je.init_shared(jcfg)
    pb = jax.tree_util.tree_map(tile, je.init_perblock(jcfg))
    cd = jax.tree_util.tree_map(tile, je.init_coder(jcfg))
    comp = jnp.zeros((B, jcfg.comp_size), jnp.uint8)
    mode = jnp.zeros(B, jnp.int32)
    step_j = jax.jit(je.make_byte_step(jcfg))
    warm = 30
    for t in range(warm):
        sh, pb, cd, _ = step_j(sh, pb, cd, comp, jnp.asarray(data[:, t]), t,
                               mode)
    state = jax.device_get((sh, pb, cd))
    sh_t, pb_t, cd_t = convert.from_jax_state(*state, device="cpu")
    # the carried state reads back leaf for leaf
    back = _flat(dict(zip("spc", convert.to_numpy(sh_t, pb_t, cd_t))))
    ref0 = _flat(dict(zip("spc", state)))
    assert set(back) == set(ref0)
    for k in ref0:
        assert np.array_equal(back[k].reshape(ref0[k].shape), ref0[k]), k

    sh, pb, cd, ys = step_j(sh, pb, cd, comp, jnp.asarray(data[:, warm]),
                            warm, mode)
    step_t = E.make_byte_step(cfg, g, CPU)
    with torch.no_grad():
        sh_t, pb_t, cd_t, e32, c32 = step_t(
            sh_t, pb_t, cd_t, torch.zeros((B, cfg.comp_size),
                                          dtype=torch.uint8),
            torch.as_tensor(data[:, warm].copy()), warm,
            torch.zeros(B, dtype=torch.int64))
    # the coded bits: exact
    e32_j = np.stack([np.asarray(y) for y in ys[:8]], axis=1)
    assert np.array_equal(e32.numpy(), e32_j.astype(np.int64))
    assert np.array_equal(c32.numpy(), np.asarray(ys[8]).astype(np.int64))
    ref = _flat(dict(zip("spc", jax.device_get((sh, pb, cd)))))
    got = _flat(dict(zip("spc", convert.to_numpy(sh_t, pb_t, cd_t))))
    assert set(got) == set(ref)
    for k, r in ref.items():
        x = got[k].reshape(r.shape)
        if r.dtype.kind == "f":
            # f32 leaves: the sum order of the mixer dots differs from
            # XLA's; qcum is the LSTM's cumulative distribution x 2^16
            tol = 0.05 if k.endswith("qcum") else 2e-5
            np.testing.assert_allclose(x, r, atol=tol, rtol=0, err_msg=k)
        else:
            _fields_close(k, x, r)
