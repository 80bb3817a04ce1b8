"""The port decodes the JAX package's committed PORT=1 archive under
``utils/profiling.KNOBS`` (``testdata/knobs.tcmx``, of the gated fixture)
exactly on the CPU (chip_smoke.py decodes it on the card and holds the
card's encode to it; test_torch_gates_runner_knobs.py holds the port's
PORT=1 encode under KNOBS to the JAX package's on the CPU)."""

import chip_smoke
import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import runner


def test_port_decodes_the_knobs_fixture():
    with open(chip_smoke.GATED_FIXTURE, "rb") as f:
        data = f.read()
    with open(chip_smoke.KNOBS_ARCHIVE, "rb") as f:
        assert runner.decompress(f.read(), device="cpu") == data
