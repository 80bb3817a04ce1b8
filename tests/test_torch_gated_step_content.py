"""One byte step of the port's engine vs the JAX package's, from identical
state, with the mechanisms that model a kind of content, in the fast
profile: VMATCH on lanes of table rows (the previous line's byte at the
column votes), and JVAL=2 with JPEGX (and SSE2 on the learned final blend)
on lanes in a recoded JPEG's coefficient planes and elsewhere."""

import numpy as np
import pytest

from torch_parity import jax_gates, routed_lanes, step_parity  # noqa: F401

WARM = 120
ROWS = [b"| alpha | beta | 1234 |\n" * 12,
        b"id,name,qty\n1,bolt,40\n2,nut,45\n3,cap,47\n" * 6,
        b"| a | b |\n| c | d |\n" * 12]


def table_lanes():
    with open("testdata/text100k.raw", "rb") as f:
        rows = ROWS + [f.read()[5000:5300]]
    return np.stack([np.frombuffer(r[:200], np.uint8) for r in rows])


CASES = {
    "vmatch": ({"VMATCH": 1}, ("vmatch_conf",)),
    "jval2_sse2": ({"JVAL": 2, "JPEGX": 1, "GRID2": 1, "SSE2": 1},
                   ("jval", "jval2", "w_sse", "w_apm")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_content_mechanism_byte_step_matches_jax(case, jax_gates):
    env, moved = CASES[case]
    jax_gates(env)
    if case == "vmatch":
        data, fields = table_lanes(), None
    else:
        data, fields = routed_lanes("jpeg", "jpeg", WARM)
    g, before, after = step_parity(env, data, fields, WARM, states=True)
    for k in moved:
        assert not np.array_equal(before[k], after[k]), k
    if case == "vmatch":
        # lengths matched so far on the rows: most of the 32 buckets learnt
        assert (after["vmatch_conf"] != np.float32(0.55)).sum() >= 4
