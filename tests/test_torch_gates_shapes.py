"""The remaining gate values without a compile: for single gates and mixes
``engine.make_gates`` gives the JAX package's derived sizes (``_derive``'s
N_BANK, N_INPUTS, _MIX1_ROWS, N_L2, M2IN, N_APM, APM_ROWS, RUNX_N,
PPM_ORDERS), and ``init_shared``/``init_perblock`` build the JAX package's
leaves (``jax.eval_shape`` of its init: the same keys, shapes and dtypes,
every optional leaf present exactly where it is there).  The sets the JAX
package accepts but cannot trace are FormatErrors here, each traced there to
its failure; two sets it traces with APM rows past its APM table are
refused too (ROADMAP.md section 3)."""

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu import engine as je
from cmix_tpu_torch import convert
from cmix_tpu_torch import engine as E
from cmix_tpu_torch.utils.profiling import GATED, KNOBS, LEAN
from test_torch_gates import _eval_step, _id
from torch_parity import jax_gates  # noqa: F401

KW = dict(block_size=64, seg_size=64, tbits=10, mbits=10, ibits=8, pbits=10,
          lstm_hidden=8, lstm_horizon=2, dmc_nodes=0)
OFF = ("WIKI", "MATCH2", "RUNX", "MIX2X", "APM2X", "STEMX", "CTX2", "CTX3",
       "CTX4", "PPM_EXCL", "PPM_UPD", "PPM_CK", "PPM_DEEP", "MIX_DYN2",
       "MIX_DYN3", "W_APM_LEARN")
CASES = ([{n: 0} for n in OFF] + [
    {"BANK_CK": 0}, {"BANK_CK": 1}, {"BANK_CK": 3}, {"BANK_CH": 1},
    {"BANK_CH": 2}, {"MIX_LR": 1e-3}, {"CNT_CAP": 30}, {"CNT_CAP": 99},
    {"MIX_NORM": 0}, {"STAT_NORM": 0}, {"CMIX_N_IND": 1}, {"CMIX_N_IND": 5},
    {"RUNX_N": 0}, {"RUNX_N": 16}, {"RUNX_N": 200}, {"RUNX": 0, "RUNX_N": -3},
    {"DMC_LEVELS": 1}, {"DMC_LEVELS": 12}, {"X86X": 1}, {"LMS": 1},
    {"LMS": 3}, {"CMIX_MATCH_ORDERS": "3,6,100"},
    {"CMIX_MATCH_ORDERS": "1,30,-1,-40,101"}, {"CMIX_PPM_ORDERS": "0,2,4"},
    {"CMIX_PPM_ORDERS": "1,3,40"}, {"CMIX_SBANK_COLS": "0,2,14"},
    {"CMIX_SBANK_COLS": "1,300,-2"}, {"SSE2": 2}, {"MIX_DYN4": 2},
    {"MIX_KIND": 3}, {"MIX_AUX": 2}, {"RUNX": 2}, {"MIX_TAU": -4.0},
    {"MIX_BOOST_N": 16.0}, {"MIX_BOOST": 1.0, "MIX_NORM": 0},
    {"APM3X": 1, "SSE2": 1, "APM2X": 0, "CMIX_SBANK_COLS": "0,2"},
    LEAN, KNOBS, dict(LEAN, PORT=1), dict(KNOBS, PORT=1), dict(GATED, **LEAN),
    dict(E.BENCH_GATES, PORT=1), dict(E.BENCH_GATES, **KNOBS),
    dict(E.BENCH_GATES, JPEGX=1, JVAL=2, GRID2=1, WRTW=2)])


def _shapes(tree, pre=""):
    """{leaf path: (shape, dtype name)} of numpy or abstract leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, pre + k + "."))
        else:
            out[pre + k] = (tuple(v.shape), np.dtype(v.dtype).name)
    return out


@pytest.mark.parametrize("env", CASES, ids=_id)
def test_sizes_and_leaves_are_the_jax_packages(env, jax_gates):
    jax_gates(env)
    g = E.make_gates(env)
    assert g.blob() == je.gates_blob()
    assert (g.n_bank, g.n_inputs, g.n_l2, g.m2in, g.n_apm, g.apm_rows,
            g.ppm_orders, g.dmc_idx) == (
        je.N_BANK, je.N_INPUTS, je.N_L2, je.M2IN, je.N_APM, je.APM_ROWS,
        je.PPM_ORDERS, je.DMC_IDX)
    assert list(g.mix1_rows) == list(je._MIX1_ROWS)
    assert list(g.mix2_off) == list(je._MIX2_OFF)
    if g.runx:
        assert g.runx_n == je.RUNX_N
    jcfg = je.EngineConfig(**KW)
    jsh = jax.eval_shape(lambda: je.init_shared(jcfg))
    jpb = jax.eval_shape(lambda: je.init_perblock(jcfg))
    cpu = torch.device("cpu")
    cfg = E.EngineConfig(**KW)
    sh, pb, _ = convert.to_numpy(E.init_shared(cfg, g, cpu),
                                 E.init_perblock(cfg, g, 1, cpu),
                                 E.init_coder(1, cpu))
    assert _shapes(sh) == _shapes(jsh)
    got = {k: ((s[1:]), d) for k, (s, d) in _shapes(pb).items()}
    assert got == _shapes(jpb)


# the JAX package accepts these (its _derive does) but its byte step fails
# when traced, so no archive carries them: FormatErrors in the port
@pytest.mark.parametrize("env", [
    {"CMIX_PPM_ORDERS": "1,30", "PPM_DEEP": 0},
    {"CMIX_PPM_ORDERS": "1,32", "PPM_DEEP": 0}, {"CMIX_PPM_ORDERS": "1,-2"},
    {"CMIX_N_IND": 9}, {"CMIX_N_IND": 0}, {"DMC_LEVELS": 0},
    {"DMC_LEVELS": -1}, {"APM3X": 2}, {"JVAL": 3, "JPEGX": 1}, {"GRID2": 2},
    {"WIKI": 2}, {"CTX4": -1}, {"MATCH2": 2}, {"BANK_CH": 0}, {"BANK_CH": 4},
    {"RUNX_N": -1}, {"APM2X": 2}, {"VMATCH": -1}], ids=_id)
def test_sets_the_jax_step_cannot_trace_are_format_errors(env, jax_gates):
    with pytest.raises(E.FormatError):
        E.make_byte_step(E.EngineConfig(**dict(KW, dmc_nodes=4096)),
                         E.make_gates(env), torch.device("cpu"))
    jax_gates(env)
    with pytest.raises((ValueError, TypeError, KeyError, IndexError,
                        AssertionError, OverflowError)):
        _eval_step()


# the JAX package traces these with APM rows past its APM table (a negative
# SSE2's rows, APM2X=-1's first rows): its reads clamp onto other rows and
# its writes drop; the port refuses them (ROADMAP.md section 3)
@pytest.mark.parametrize("env", [{"SSE2": -1}, {"APM2X": -1}], ids=_id)
def test_apm_rows_past_the_table_are_refused(env, jax_gates):
    with pytest.raises(E.FormatError):
        E.make_gates(env)
    jax_gates(env)
    _eval_step()
    assert je.APM_ROWS < 576 + 512 * max(je.APM2X, 0) + 256 * max(je.SSE2, 0)
