"""The runner under ``utils/profiling.KNOBS`` on the CPU, as
test_torch_gates_runner.py holds ``LEAN``: a small-width fast round trip,
and the PORT=1 archives byte-identical across the packages, each decoding
the other's."""

import pytest

from cmix_tpu_torch.utils.profiling import KNOBS
from test_torch_gates_runner import check_fast_round_trip, \
    check_port_cross_decode


@pytest.mark.parametrize("leg", ["fast", "port"])
def test_knobs_runner(leg):
    (check_fast_round_trip if leg == "fast" else check_port_cross_decode)(
        KNOBS)
