"""One byte step of the port's engine against the JAX package's, from
identical state, at the joint branches of the branch table
(test_torch_gates_step.py's docstring):

* JOINT, fast profile, on x86 code and text: BANK_CK=0 with RUNX on (the
  row header's ``elif RUNX``), MIX_NORM=0 with MIX_BOOST (the per-row
  counts ``w1_cnt``), X86X=1 and LMS=1 (the two values only a direct
  engine caller sets: the runners route 0 or 2), PPM_CK without PPM_DEEP,
  STAT_NORM=0 under VMATCH, SBANK_ADAPT and LMS, and SSE2 and APM3X with
  APM2X=0 and a state-bank column list without column 1;
* BENCH_PORT, PORT=1: the bench set with PORT=1 and the SSE2 and APM3X
  mechanisms, mixed with RUNX=0 under BANK_CK=2 (the header's ``else``),
  PPM_DEEP without PPM_CK, APM2X=0 and no column 1.

Tolerance: integer leaves and the coded bits exact, float32 leaves within
2e-5 (the LSTM's cumulative distribution within 0.05); under PORT=1 every
leaf exact (``torch_parity.step_parity``)."""

import numpy as np
import pytest

from cmix_tpu_torch.engine import BENCH_GATES
from test_torch_gates_step import WARM
from torch_parity import jax_gates, routed_lanes, step_parity  # noqa: F401

NO_COL1 = "0,2,3,7,14"
JOINT = {"BANK_CK": 0, "MIX_NORM": 0, "MIX_BOOST": 2.0, "MIX_BOOST_N": 32.0,
         "X86X": 1, "LMS": 1, "PPM_DEEP": 0, "STAT_NORM": 0, "VMATCH": 1,
         "SBANK_ADAPT": 1, "SSE2": 1, "APM3X": 1, "APM2X": 0,
         "CMIX_SBANK_COLS": NO_COL1}
BENCH_PORT = dict(BENCH_GATES, PORT=1, SSE2=1, APM3X=1, APM2X=0, RUNX=0,
                  PPM_DEEP=1, CMIX_SBANK_COLS=NO_COL1)


def test_joint_branches_fast(jax_gates):
    jax_gates(JOINT)
    data, _ = routed_lanes("exe", None, WARM)
    g, before, after = step_parity(JOINT, data, {"blk_kind": [2, 2, 1, 2]},
                                   WARM, states=True)
    assert (g.x86x, g.lms, g.n_apm, g.sse2_base) == (1, 1, 4, 832)
    assert g.n_bank == 47 + 8 + 4 + 2 + 2 + 8 + 8 + 8     # X86X=1: +2
    assert "ppm_ck" in after and after["ppm"].shape[0] == 12
    # MIX_BOOST's per-row counts and the always-on LMS's confidences moved
    for k in ("w1_cnt", "lms_conf", "sbank_c", "w_sse", "runx_conf"):
        assert not np.array_equal(before[k], after[k]), k


def test_bench_with_port_and_mechanisms(jax_gates):
    jax_gates(BENCH_PORT)
    data, _ = routed_lanes("exe", None, WARM)
    g, before, after = step_parity(BENCH_PORT, data,
                                   {"blk_kind": [2, 2, 1, 2]}, WARM,
                                   states=True)
    assert g.port and g.dmc_levels == 7 and g.bank_ch == 1
    assert "runx_conf" not in after and "ppm_ck" not in after
    assert after["ppm"].shape[0] == 14                 # + PPM_DEEP's two
    assert after["apm"].shape[0] == 576 + 256 + 256
    for k in ("w_sse", "apm"):
        assert not np.array_equal(before[k], after[k]), k
