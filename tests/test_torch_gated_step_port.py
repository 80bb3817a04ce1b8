"""One byte step of the port's engine vs the JAX package's, from identical
state, in the portable profile (PORT=1: every leaf exact) with the
off-by-default mechanisms it allows: the mixer set (MIX_DYN4, MIX_KIND,
MIX_AUX; MIX_TAU and MIX_BOOST are float-internal, a FormatError under
PORT) and the SSE set (APM3X, SSE2, APM_FIXED; SBANK_ADAPT cannot be coded
under PORT, test_torch_gates.py)."""

import numpy as np
import pytest

from test_torch_gated_step import WARM, text_lanes
from torch_parity import jax_gates, step_parity  # noqa: F401

CASES = {
    "port_mixer": ({"PORT": 1, "MIX_DYN4": 1, "MIX_KIND": 1, "MIX_AUX": 1},
                   ("w1", "w2", "w2b")),
    "port_sse": ({"PORT": 1, "APM3X": 1, "SSE2": 1, "APM_FIXED": 1},
                 ("w_sse", "apm")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gated_port_byte_step_matches_jax(case, jax_gates):
    env, moved = CASES[case]
    jax_gates(env)
    g, before, after = step_parity(env, text_lanes(),
                                   {"blk_kind": [1, 2, 3, 0]}, WARM,
                                   states=True)
    assert g.port
    for k in moved:
        assert not np.array_equal(before[k], after[k]), k
