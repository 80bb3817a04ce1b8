"""The runner under ``utils/profiling.KNOBS`` on the CPU, as
test_torch_gates_runner.py holds ``LEAN``: a small-width fast round trip,
and the PORT=1 archives byte-identical across the packages (the golden
``knobs_runner``), each decoding the other's (the JAX package's decode
under ``RUN_SLOW=1 pytest tests/test_torch_goldens.py``)."""

import pytest

from cmix_tpu_torch.utils.profiling import KNOBS
from test_torch_gates_runner import check_fast_round_trip, \
    check_port_cross_decode


@pytest.mark.parametrize("leg", ["fast", "port"])
def test_knobs_runner(leg):
    if leg == "fast":
        check_fast_round_trip(KNOBS)
    else:
        check_port_cross_decode(KNOBS, "knobs_runner")
