"""One byte step of the port's engine vs the JAX package's, from identical
state, at the content-routed gates on the two other gate sets: the bench
speed profile with X86X=2, and the portable profile (PORT=1) with X86X=2,
GRID2 and JPEGX, where every leaf must agree exactly."""

import pytest

from cmix_tpu_torch.engine import BENCH_GATES
from torch_parity import jax_gates, routed_lanes, step_parity  # noqa: F401

WARM = 120                               # steps before the compared one

CASES = {
    "bench_x86": (dict(BENCH_GATES, X86X=2), "exe", None),
    "port_routed": ({"PORT": 1, "X86X": 2, "GRID2": 1, "JPEGX": 1}, "jpeg",
                    "jpeg"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_routed_byte_step_matches_jax(case, jax_gates):
    env, lanes, fields = CASES[case]
    jax_gates(env)
    data, fields = routed_lanes(lanes, fields, WARM)
    g = step_parity(env, data, fields, WARM)
    assert g.port == (case == "port_routed") and g.x86x == 2
