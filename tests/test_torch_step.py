"""One byte step of the port's engine vs the JAX package's, from identical
state (carried across with ``convert.from_jax_state``), for both gate sets
the fast profile runs on text: the defaults and the bench speed profile.
The comparison and its tolerances are ``torch_parity.step_parity``'s."""

import numpy as np
import pytest

from cmix_tpu_torch import engine as E
from torch_parity import jax_gates, step_parity  # noqa: F401

B = 4


@pytest.mark.parametrize("gates", ["default", "bench"])
def test_byte_step_matches_jax_from_identical_state(gates, jax_gates):
    env = E.BENCH_GATES if gates == "bench" else {}
    jax_gates(env)
    data = np.frombuffer(open("testdata/text100k.raw", "rb").read()[
        :B * 512], np.uint8).reshape(B, 512)
    step_parity(env, data)
