"""One byte step of the port's engine against the JAX package's, from
identical state, under the remaining gate values (ROADMAP queue 1: the
default-on components switched off, the value knobs, their mixes), in the
fast profile: ``utils/profiling.LEAN`` and ``KNOBS`` on text lanes.  The
portable profile of both sets is test_torch_gates_step_port.py; the joint
branches, X86X=1, LMS=1 and the bench set with PORT=1 and mechanisms are
test_torch_gates_step_joint.py.

Tolerance (``torch_parity.step_parity``): the coded bits exact; integer
leaves exact (the packed bank and d12 slots' st13 and p12 fields within one
rounding step, the state bank's st13 field too); float32 leaves within 2e-5
absolute, the LSTM's cumulative distribution (x 2^16) within 0.05.  Under
PORT=1 every leaf exact.

Each case shows that its gates took effect: a leaf that the default set
has is absent, a table moved that only its gates move, or a width is the
one its gates give.

The branch table.  Every branch site of cmix_tpu/engine.py on one of these
gates; the default set takes one side, the set named takes the other (LEAN,
KNOBS: these sets in the fast profile here and under PORT=1 in
test_torch_gates_step_port.py; JOINT and BENCH_PORT: the two sets of
test_torch_gates_step_joint.py, the first fast, the second PORT=1):

====================================  ===========================  ===========
site (cmix_tpu/engine.py)             branch                       taken by
====================================  ===========================  ===========
_bank_bases_b :1108, ind_keys :3004   CMIX_N_IND=4                 KNOBS
_bank_bases_b :1109/:1141/:1144       WIKI=0/STEMX=0/CTX2=0        LEAN
_bank_bases_b :1161/:1185, :1619      CTX3=0 / CTX4=0              LEAN
_bank_bases_b :1125-1130              X86X=1 (no second pair)      JOINT
_predict_tree_b :1634                 BANK_CK=1 (one way)          KNOBS
_predict_tree_b :1634 / :1661         BANK_CK=0                    LEAN, JOINT
_predict_tree_b :1712, _update :2612  MATCH2=0                     LEAN
_aux_writes_b :2929-2982, :3010       MATCH2=0 (one slot per key)  LEAN
PPM orders :1764-1767                 CMIX_PPM_ORDERS, 6 orders    KNOBS
_ppm_blend_f32 :1457, _int :1509      PPM_EXCL=0                   LEAN
_predict_tree_b :1776, _update :2404  PPM_CK=0 (PPM_DEEP on)       BENCH_PORT
init :926, PPM :1766, step :3057      PPM_DEEP=0 (PPM_CK on)       JOINT
_update_tree_b :2375                  PPM_UPD=0                    LEAN
_predict_tree_b :1823-1849, :2631     LMS=1 (always on)            JOINT
_predict_tree_b :1870, _update :2615  RUNX=0                       LEAN
_predict_tree_b :1874                 RUNX_N=16                    KNOBS
_predict_tree_b :1946-1962            BANK_CH=2                    KNOBS
_update :2651-2662, _int :2786        BANK_CH=2 (quarter rate)     KNOBS
_predict_tree_b :1980-1988            MIX_DYN2=0, MIX_DYN3=0       LEAN
_predict_tree_b :2030-2064            MIX2X=0                      LEAN
_predict_tree_b :2031                 no column 1 (MIX2X)          KNOBS
_update :2701-2711, _int :2833        MIX2X=0                      LEAN
_predict_tree_b :2100-2105            APM2X=0                      LEAN
APM3X :2107-2109, SSE2 :2138-2139     APM2X=0, no column 1         BENCH_PORT
SSE2 :2173-2174 (fast)                APM2X=0, no column 1         JOINT
_update_tree_b :2297                  neither RUNX nor BANK_CK     LEAN
_update_tree_b :2299 (elif RUNX)      RUNX=1, BANK_CK=0            JOINT
_update_tree_b :2306 (else)           BANK_CK=2, RUNX=0            BENCH_PORT
d0 :2329/:2342, SEE :2439/:2460       STAT_NORM=0                  KNOBS
state bank :2516 / :2549              STAT_NORM=0                  KNOBS
SBANK_ADAPT counts :2561              STAT_NORM=0, SBANK_ADAPT=1   JOINT
match confidences :2587 / :2603       STAT_NORM=0                  KNOBS
VMATCH :2626, LMS :2639               STAT_NORM=0                  JOINT
slots :1385/:2244, d0 :2336/:2346     CNT_CAP=30                   KNOBS
mixer rate :2258, _int :2778          MIX_LR=1e-3                  KNOBS
_update :2648-2717 (summed .add)      MIX_NORM=0                   KNOBS
_update :2676-2681 (w1_cnt)           MIX_NORM=0, MIX_BOOST=2      JOINT
_update_mixers_int :2792-2856         MIX_NORM=0                   KNOBS
_update :2746, _int :2882             W_APM_LEARN=0                LEAN
models/dmc.py walk depth              DMC_LEVELS=4                 KNOBS
====================================  ===========================  ===========
"""

import numpy as np
import pytest

from cmix_tpu_torch.utils.profiling import KNOBS, LEAN
from torch_parity import jax_gates, step_parity  # noqa: F401

WARM = 30


def text_lanes():
    with open("testdata/text100k.raw", "rb") as f:
        text = f.read()
    return np.stack([np.frombuffer(text[o:o + 200], np.uint8)
                     for o in (0, 3000, 7000, 20000)])


def check_took_effect(name, g, before, after):
    """The LEAN/KNOBS gates' effects on the shared state after one step."""
    if name == "lean":
        for k in ("match2_conf", "runx_conf", "w2x", "ppm_ck"):
            assert k not in after, k
        assert (g.n_bank, g.n_mix1, g.n_l2, g.n_apm) == (55, 11, 3, 3)
        # W_APM_LEARN=0: the final blend keeps its start
        assert np.array_equal(before["w_apm"], after["w_apm"])
        assert after["bank"].shape[0] == 55
    else:
        assert (g.n_ind, g.runx_n, g.bank_ch, g.dmc_levels) == (4, 16, 2, 4)
        assert after["runx_conf"].shape == (16, 32)
        assert after["ppm"].shape[0] == 6 + 2          # + PPM_DEEP's two
        assert g.n_inputs == g.n_primary + g.n_bank    # BANK_CH=2
        # the summed mixer updates (MIX_NORM=0) and the summed statistics
        # (STAT_NORM=0) moved their tables
        for k in ("w1", "w2b", "d0_p", "sbank_p", "runx_conf"):
            assert not np.array_equal(before[k], after[k]), k
        # CNT_CAP=30: no slot count beyond it
        assert (after["d12"] & 0x3F).max() <= 30


@pytest.mark.parametrize("name", ["lean", "knobs"])
def test_gates_byte_step_matches_jax(name, jax_gates):
    env = {"lean": LEAN, "knobs": KNOBS}[name]
    jax_gates(env)
    g, before, after = step_parity(env, text_lanes(),
                                   {"blk_kind": [1, 2, 3, 0]}, WARM,
                                   states=True)
    check_took_effect(name, g, before, after)
