"""The portable profile (PORT=1): one byte step of the port's engine
against the JAX package's from identical state, and the gate rules.

Everything that feeds the coder is integer in this profile, so the p16
tree, the coded bits and every state leaf must agree exactly."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu import engine as je
from cmix_tpu_torch import convert
from cmix_tpu_torch import engine as E

CPU = torch.device("cpu")
B = 4
KW = dict(block_size=512, seg_size=256, tbits=12, mbits=12, ibits=10,
          pbits=12, lstm_hidden=32, dmc_nodes=5120, lstm_horizon=4)
# leaves the JAX package keeps in float32 under PORT: the strided LMS's
# taps and error, which PORT switches off (LMS=0) -- never updated, so
# they too must agree exactly
FLOAT_LEAVES = {"p.lms_w", "p.lms_err"}
PORT_SETS = {"sgd": {"PORT": 1},
             "adam": {"PORT": 1, "ILSTM_ADAM": 1, "ILSTM_LRX": 6}}


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


@pytest.mark.parametrize("which", sorted(PORT_SETS))
def test_port_byte_step_matches_jax_from_identical_state(which, jax_gates):
    env = PORT_SETS[which]
    jax_gates(env)
    g = E.make_gates(env)
    assert g.port and g.blob() == je.gates_blob()
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
    # the port's fresh state has the JAX package's keys and dtypes
    fresh = _flat(dict(zip("spc", convert.to_numpy(
        E.init_shared(cfg, g, CPU), E.init_perblock(cfg, g, B, CPU),
        E.init_coder(B, CPU)))))
    ref0 = _flat(dict(zip("spc", state)))
    assert set(fresh) == set(ref0)
    for k in ref0:
        assert fresh[k].dtype == ref0[k].dtype, k
    assert {k for k, v in ref0.items() if v.dtype.kind == "f"} \
        == FLOAT_LEAVES

    # the p16 tree of the next byte, from identical state
    p16_j = np.asarray(jax.jit(lambda s, p: je._predict_tree_b(
        jcfg, s, p, warm)[0])(sh, pb))
    C = E._Consts(g, CPU)
    with torch.no_grad():
        p16_t, _ = E._predict_tree_b(cfg, g, C, copy.deepcopy(sh_t),
                                     copy.deepcopy(pb_t), torch.tensor(warm))
    assert p16_t.dtype == torch.int32
    assert np.array_equal(p16_t.numpy(), p16_j)

    sh, pb, cd, ys = step_j(sh, pb, cd, comp, jnp.asarray(data[:, warm]),
                            warm, mode)
    step_t = E.make_byte_step(cfg, g, CPU)
    with torch.no_grad():
        sh_t, pb_t, cd_t, e32, c32 = step_t(
            sh_t, pb_t, cd_t, torch.zeros((B, cfg.comp_size),
                                          dtype=torch.uint8),
            torch.as_tensor(data[:, warm].copy()), torch.tensor(warm),
            torch.zeros(B, dtype=torch.int64))
    e32_j = np.stack([np.asarray(y) for y in ys[:8]], axis=1)
    assert np.array_equal(e32.numpy(), e32_j.astype(np.int64))
    assert np.array_equal(c32.numpy(), np.asarray(ys[8]).astype(np.int64))
    ref = _flat(dict(zip("spc", jax.device_get((sh, pb, cd)))))
    got = _flat(dict(zip("spc", convert.to_numpy(sh_t, pb_t, cd_t))))
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert np.array_equal(got[k].reshape(r.shape), r), k


@pytest.mark.parametrize("other", [{"VMATCH": 1}, {"LMS": 1},
                                   {"MIX_TAU": 100.0}, {"MIX_BOOST": 2.0}])
def test_port_with_a_float_internal_path_is_a_format_error(other):
    with pytest.raises(E.FormatError, match="PORT=1 requires"):
        E.make_gates(dict(other, PORT=1))


@pytest.mark.parametrize("env", [{"PORT": 1}, {"PORT": 1, "ILSTM_ADAM": 1},
                                 {"PORT": 1, "ILSTM_LRX": 2},
                                 {"ILSTM_LRX": 8}])
def test_port_gate_sets_are_accepted_with_the_jax_blob(env, jax_gates):
    jax_gates(env)
    assert E.make_gates(env).blob() == je.gates_blob()
    assert E.gates_from_blob(je.gates_blob()) == E.make_gates(env)
