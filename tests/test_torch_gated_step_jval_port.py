"""One byte step of the port's engine vs the JAX package's, from identical
state, in the portable profile (PORT=1: every leaf exact) with JVAL=2 and
JPEGX, APM3X and SSE2 on the learned final blend, on lanes in a recoded
JPEG's header and coefficient planes, without JPEG, and a dummy lane's
pad: the integer JVAL channel, and the byte-count rows written by the
highest block among those on the planes."""

import numpy as np

from test_torch_gated_step_content import WARM
from torch_parity import jax_gates, routed_lanes, step_parity  # noqa: F401


def test_port_jval_byte_step_matches_jax(jax_gates):
    env = {"PORT": 1, "JVAL": 2, "JPEGX": 1, "GRID2": 1, "APM3X": 1,
           "SSE2": 1}
    jax_gates(env)
    data, fields = routed_lanes("jpeg", "jpeg", WARM)
    g, before, after = step_parity(env, data, fields, WARM, states=True)
    assert g.port and g.jval == 2
    for k in ("jval", "jval2", "w_sse", "w_apm"):
        assert not np.array_equal(before[k], after[k]), k
    # one lane is on the planes at the compared step: one row of each tier
    for k in ("jval", "jval2"):
        assert (before[k] != after[k]).any(axis=1).sum() == 1, k
