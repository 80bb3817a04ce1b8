"""The port decodes the JAX package's committed PORT=1 archive under
``utils/profiling.KNOBS`` (``testdata/knobs.tcmx``, of the gated fixture)
exactly on the CPU (chip_smoke.py decodes it on the card and holds the
card's encode to it; test_torch_gates_runner_knobs.py holds the port's
PORT=1 encode under KNOBS to the JAX package's on the CPU)."""

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import runner
from golden_cases import read_case


def test_port_decodes_the_knobs_fixture():
    _, data, _, arc = read_case("knobs")
    assert runner.decompress(arc, device="cpu") == data
