"""One byte step of the port's engine against the JAX package's under
PORT=1, from identical state, with ``utils/profiling.LEAN`` and ``KNOBS``
on top: every leaf exact (``torch_parity.step_parity``), the integer
mixers' summed updates (MIX_NORM=0) included.  Each case shows that its
gates took effect as in test_torch_gates_step.py, whose docstring holds the
branch table."""

import pytest

from cmix_tpu_torch.utils.profiling import KNOBS, LEAN
from test_torch_gates_step import WARM, check_took_effect, text_lanes
from torch_parity import jax_gates, step_parity  # noqa: F401


@pytest.mark.parametrize("name", ["lean", "knobs"])
def test_gates_byte_step_matches_jax_port(name, jax_gates):
    env = dict({"lean": LEAN, "knobs": KNOBS}[name], PORT=1)
    jax_gates(env)
    g, before, after = step_parity(env, text_lanes(),
                                   {"blk_kind": [1, 2, 3, 0]}, WARM,
                                   states=True)
    assert g.port
    check_took_effect(name, g, before, after)
