"""One byte step of the port's engine vs the JAX package's, from identical
state, in the fast profile with the off-by-default mechanisms: the mixer
set (MIX_DYN4, MIX_KIND, MIX_AUX, MIX_TAU, MIX_BOOST) and the SSE set
(APM3X, SSE2, SBANK_ADAPT, APM_FIXED) on text lanes of four content kinds.
Each case also shows that its mechanisms took part: their tables moved in
the step.  (VMATCH and JVAL: test_torch_gated_step_content.py; the
portable profile: test_torch_gated_step_port.py.)"""

import numpy as np
import pytest

from torch_parity import jax_gates, step_parity  # noqa: F401

WARM = 40


def text_lanes():
    with open("testdata/text100k.raw", "rb") as f:
        text = f.read()
    return np.stack([np.frombuffer(text[o:o + 200], np.uint8)
                     for o in (0, 3000, 7000, 20000)])


CASES = {
    "mixer": ({"MIX_DYN4": 1, "MIX_KIND": 1, "MIX_AUX": 1, "MIX_TAU": 100.0,
               "MIX_BOOST": 2.0}, ("w1", "w2", "w2b")),
    "sse": ({"APM3X": 1, "SSE2": 1, "SBANK_ADAPT": 1, "APM_FIXED": 1},
            ("w_sse", "sbank_c", "apm")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gated_byte_step_matches_jax(case, jax_gates):
    env, moved = CASES[case]
    jax_gates(env)
    g, before, after = step_parity(env, text_lanes(),
                                   {"blk_kind": [1, 2, 3, 0]}, WARM,
                                   states=True)
    for k in moved:
        assert not np.array_equal(before[k], after[k]), k
    if case == "mixer":
        assert (g.n_mix1, g.m2in) == (26, 29)
        # MIX_KIND's rows (the last 64): the four kinds' rows moved
        assert not np.array_equal(before["w1"][-64:], after["w1"][-64:])
