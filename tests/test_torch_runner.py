"""The port's archive container against the JAX package's, default gates:
same header, gate record and length table flags; coded size within 1%;
exact round trip with a padded exec batch and a raw-stored block; at LSTM
horizon 4 and at 8, the CLI's above 256 KiB of input."""

import pytest

from torch_parity import check_runner_against_jax


@pytest.mark.parametrize("horizon", [4, 8])
def test_runner_matches_jax_default_gates(horizon):
    check_runner_against_jax({}, horizon)
