"""The committed knobs fixture that chip_smoke.py decodes and re-encodes on
the card (``testdata/knobs.tcmx``: the JAX package's PORT=1 archive of
``testdata/gated.raw`` under ``utils/profiling.KNOBS`` at the gated path's
small widths, one group; the golden ``knobs``) has the KNOBS gates (and
the routed ones) in its gate record.  ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-encodes it with the JAX package on the
CPU.  test_torch_gates_port_decode.py has the port decode it and encode it
again.

To rewrite it after a deliberate format change:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
--write-goldens knobs``."""

from cmix_tpu_torch import engine as te
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils.profiling import KNOBS
from golden_cases import read_case


def test_knobs_fixture_archive_is_the_jax_packages_encode():
    e, _, _, arc = read_case("knobs")
    assert e["gates"] == dict(KNOBS, PORT=1)
    off = 4 + runner._HDR_LEN
    glen = int.from_bytes(arc[off:off + 2], "little")
    assert arc[off + 2:off + 2 + glen] == te.make_gates(dict(
        KNOBS, PORT=1, X86X=2, GRID2=1, JPEGX=1)).blob()
