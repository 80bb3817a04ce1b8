"""One byte step of the port's engine vs the JAX package's, from identical
state, at the content-routed gate sets of the fast profile: X86X=2 on x86
lanes, GRID2 with the strided LMS (forced strides and media kinds on some
lanes), and JPEGX with GRID2 (lanes in a recoded JPEG's header, in a
coefficient plane, without JPEG, and a dummy lane's pad)."""

import pytest

from torch_parity import jax_gates, routed_lanes, step_parity  # noqa: F401

WARM = 120                               # steps before the compared one

# per case: the gate set, the lanes, and the per-block fields
CASES = {
    "x86": ({"X86X": 2}, "exe", None),
    "grid2_lms": ({"GRID2": 1, "LMS": 2}, "media",
                  {"rec_forced": [48, 4, 0, 0], "blk_kind": [3, 5, 1, 0]}),
    "jpegx_grid2": ({"JPEGX": 1, "GRID2": 1}, "jpeg", "jpeg"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_routed_byte_step_matches_jax(case, jax_gates):
    env, lanes, fields = CASES[case]
    jax_gates(env)
    data, fields = routed_lanes(lanes, fields, WARM)
    g = step_parity(env, data, fields, WARM)
    assert g.n_bank == 85 + {"x86": 4, "grid2_lms": 2, "jpegx_grid2": 10}[case]
    assert bool(g.lms) == (case == "grid2_lms")
