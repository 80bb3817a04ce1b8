"""The gate rules of the off-by-default mechanisms (SSE2, APM3X, MIX_DYN4,
MIX_KIND, MIX_AUX, SBANK_ADAPT, VMATCH, APM_FIXED, JVAL, MIX_TAU,
MIX_BOOST): ``engine.make_gates`` accepts each alone and all together in
every profile the JAX package codes them in, with the JAX package's gate
record and derived widths; it raises FormatError where the JAX package
does, and where the JAX package accepts a set that its byte step cannot
trace (no archive carries it).  The mechanisms at other values and mixed
with the remaining gates are accepted too (test_torch_gates_shapes.py has
the wider list)."""

import jax
import jax.numpy as jnp
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu import engine as je
from cmix_tpu_torch import engine as E
from cmix_tpu_torch.utils.profiling import GATED, GATED_PORT
from torch_parity import jax_gates  # noqa: F401

FAST_ONLY = ("VMATCH", "SBANK_ADAPT", "MIX_TAU", "MIX_BOOST")
ALONE = [{"SSE2": 1}, {"APM3X": 1}, {"MIX_DYN4": 1}, {"MIX_KIND": 1},
         {"MIX_AUX": 1}, {"SBANK_ADAPT": 1}, {"VMATCH": 1}, {"APM_FIXED": 1},
         {"JVAL": 1, "JPEGX": 1}, {"JVAL": 2, "JPEGX": 1, "GRID2": 1},
         {"MIX_TAU": 500.0}, {"MIX_BOOST": 1.5},
         {"MIX_BOOST": 2.0, "MIX_BOOST_N": 16.0}]
SETS = ALONE + [GATED, dict(GATED, JVAL=2, JPEGX=1, X86X=2, LMS=2),
                GATED_PORT, dict(GATED_PORT, JVAL=1, JPEGX=1, WRTW=2)]
SETS += [dict(env, PORT=1) for env in ALONE
         if not set(env) & set(FAST_ONLY)]


def _id(env):
    return ",".join(f"{k}={v}" for k, v in sorted(env.items()))


@pytest.mark.parametrize("env", SETS, ids=_id)
def test_accepted_with_the_jax_record_and_widths(env, jax_gates):
    jax_gates(env)
    g = E.make_gates(env)
    assert g.blob() == je.gates_blob()
    assert E.gates_from_blob(je.gates_blob()) == g
    assert (g.n_inputs, g.n_mix1, g.mix1_total, g.m2in, g.n_apm,
            g.apm_rows) == (je.N_INPUTS, je.N_MIX1, je._MIX1_TOTAL, je.M2IN,
                            je.N_APM, je.APM_ROWS)
    assert list(g.mix1_off) == list(je._MIX1_OFF)
    assert g.aux_taps == (je.N_BANK + 4 + je.N_MATCH,
                          je.N_BANK + 5 + je.N_MATCH, je.DMC_IDX)


@pytest.mark.parametrize("name", FAST_ONLY)
def test_fast_only_mechanisms_with_port_are_format_errors(name, jax_gates):
    env = dict(next(e for e in ALONE if name in e), PORT=1)
    with pytest.raises(E.FormatError, match="PORT=1"):
        E.make_gates(env)
    if name != "SBANK_ADAPT":
        with pytest.raises(je.FormatError, match="PORT=1 requires"):
            jax_gates(env)


def test_unknown_x86x_is_a_format_error_in_both_packages(jax_gates):
    with pytest.raises(E.FormatError, match="X86X=3"):
        E.make_gates({"X86X": 3})
    with pytest.raises(je.FormatError, match="X86X=3"):
        jax_gates({"X86X": 3})


# the JAX package accepts these gate sets but its byte step fails when it is
# traced (PORT's integer rate shift of float32 visit counts; JVAL's contexts
# are None without JPEGX), so no archive of it carries them: the port
# refuses them up front
@pytest.mark.parametrize("env,err", [
    ({"PORT": 1, "SBANK_ADAPT": 1}, TypeError),
    ({"JVAL": 1}, TypeError)], ids=["port_sbank_adapt", "jval_alone"])
def test_sets_the_jax_step_cannot_trace_are_format_errors(env, err,
                                                          jax_gates):
    with pytest.raises(E.FormatError):
        E.make_gates(env)
    jax_gates(env)
    with pytest.raises(err):
        _eval_step(dmc_nodes=0)


def _eval_step(dmc_nodes=4096):
    """Trace (``jax.eval_shape``) one byte step of the JAX package at its
    live gates, small widths, B=2."""
    kw = dict(block_size=64, seg_size=64, tbits=10, mbits=10, ibits=8,
              pbits=10, lstm_hidden=0, dmc_nodes=dmc_nodes)
    cfg = je.EngineConfig(**kw)
    tile = lambda x: jnp.tile(x[None], (2,) + (1,) * x.ndim)   # noqa: E731
    pb = jax.tree_util.tree_map(tile, je.init_perblock(cfg))
    cd = jax.tree_util.tree_map(tile, je.init_coder(cfg))
    return jax.eval_shape(je.make_byte_step(cfg), je.init_shared(cfg), pb,
                          cd, jnp.zeros((2, cfg.comp_size), jnp.uint8),
                          jnp.zeros(2, jnp.uint8), 0,
                          jnp.zeros(2, jnp.int32))


# the sets the port refused until it ported the remaining gate values (the
# test keeps its name): now accepted with the JAX package's gate record and
# widths, or, where the JAX step cannot trace the set (VMATCH=3: one vote
# channel against three counted inputs), a FormatError in both
@pytest.mark.parametrize("env", [
    {"SSE2": 2}, {"VMATCH": 3}, {"MIX_TAU": -4.0}, {"MIX_BOOST_N": 16.0},
    {"W_APM_LEARN": 0}, {"APM2X": 0}, {"MATCH2": 0},
    dict(E.BENCH_GATES, APM3X=1), dict(E.BENCH_GATES, JVAL=1, JPEGX=1)],
    ids=_id)
def test_the_rest_names_item_15b(env, jax_gates):
    jax_gates(env)
    if env.get("VMATCH") == 3:
        with pytest.raises(E.FormatError, match="VMATCH=3"):
            E.make_gates(env)
        with pytest.raises(ValueError):
            _eval_step()
        return
    g = E.make_gates(env)
    assert g.blob() == je.gates_blob()
    assert (g.n_bank, g.n_inputs, g.n_mix1, g.m2in, g.n_l2, g.n_apm,
            g.apm_rows) == (je.N_BANK, je.N_INPUTS, je.N_MIX1, je.M2IN,
                            je.N_L2, je.N_APM, je.APM_ROWS)


def test_the_runner_routes_jval_with_jpegx(monkeypatch):
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.preprocess import wrt
    jpeg = [(wrt.SEG_JPEGC, 10, 10, 4, 0, (1, 1, 1))]
    text = [(wrt.SEG_TEXT, 10, 10)]
    assert runner._routed_gates(jpeg, False, None)["JVAL"] == 0
    monkeypatch.setenv("JVAL_ROUTE", "2")
    assert runner._routed_gates(jpeg, True, None)["JVAL"] == 2
    assert runner._routed_gates(text, False, None)["JVAL"] == 0
    monkeypatch.setenv("WRTW_ROUTE", "2")
    assert runner._routed_gates(text, False, "d")["WRTW"] == 2
    # a caller's JVAL gives way to the routed value, as in the JAX package
    g = E.make_gates(dict(runner.env_gates({"JVAL": "1", "SSE2": "1",
                                            "HOME": "/"}),
                          **runner._routed_gates(text, False, None)))
    assert g.blob() == b"SSE2=1"
