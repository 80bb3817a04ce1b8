"""The committed knobs fixture that chip_smoke.py decodes and re-encodes on
the card (``testdata/knobs.tcmx``: the JAX package's PORT=1 archive of
``testdata/gated.raw`` under ``utils/profiling.KNOBS`` at the gated path's
small widths, one group; the golden ``knobs``) cannot go stale: the
archive is the golden of that input and call, with the KNOBS gates (and
the routed ones) in its gate record.  ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-encodes it with the JAX package on the
CPU.  test_torch_gates_port_decode.py has the port decode it and encode it
again.

To rewrite it after a deliberate format change:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
--write-goldens knobs``."""

import chip_smoke
from cmix_tpu_torch import engine as te
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils.profiling import KNOBS
from torch_parity import jax_golden


def test_knobs_fixture_archive_is_the_jax_packages_encode():
    with open(chip_smoke.GATED_FIXTURE, "rb") as f:
        data = f.read()
    arc = jax_golden("knobs", data, config=chip_smoke.GATED_SMALL,
                     gates=dict(KNOBS, PORT=1),
                     max_batch=chip_smoke.GATED_BATCH)
    with open(chip_smoke.KNOBS_ARCHIVE, "rb") as f:
        assert f.read() == arc
    off = 4 + runner._HDR_LEN
    glen = int.from_bytes(arc[off:off + 2], "little")
    assert arc[off + 2:off + 2 + glen] == te.make_gates(dict(
        KNOBS, PORT=1, X86X=2, GRID2=1, JPEGX=1)).blob()
