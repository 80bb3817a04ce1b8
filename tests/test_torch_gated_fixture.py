"""The committed gated fixture that chip_smoke.py holds the card to
(``testdata/gated.raw``: the routed fixture and ~1 KiB of text with table
rows; ``testdata/gated.tcmx``: the JAX package's PORT=1 archive of it with
every off-by-default mechanism the portable profile allows and JVAL=2, the
golden ``gated``) cannot go stale: the archive is the golden of that input
at chip_smoke's config, its gate record is the port's for those gates, and
the input is still what ``make_gated_input`` makes.  ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-encodes it with the JAX package on the
CPU.

To rewrite the archive after a deliberate format change:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
--write-goldens gated``."""

import chip_smoke
from cmix_tpu_torch import engine as te
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils.profiling import GATED_PORT
from torch_parity import jax_golden, make_gated_input


def test_gated_fixture_archive_is_the_jax_packages_encode():
    with open(chip_smoke.GATED_FIXTURE, "rb") as f:
        data = f.read()
    assert data == make_gated_input()
    arc = jax_golden("gated", data, config=chip_smoke.GATED_SMALL,
                     gates=GATED_PORT,
                     env={"JVAL_ROUTE": chip_smoke.JVAL_ROUTE},
                     max_batch=chip_smoke.GATED_BATCH)
    with open(chip_smoke.GATED_ARCHIVE, "rb") as f:
        assert f.read() == arc
    off = 4 + runner._HDR_LEN
    glen = int.from_bytes(arc[off:off + 2], "little")
    assert arc[off + 2:off + 2 + glen] == te.make_gates(dict(
        GATED_PORT, X86X=2, GRID2=1, JPEGX=1, JVAL=2)).blob()
