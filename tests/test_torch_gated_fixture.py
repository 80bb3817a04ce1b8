"""The committed gated fixture that chip_smoke.py holds the card to
(``testdata/gated.raw``: the routed fixture and ~1 KiB of text with table
rows; ``testdata/gated.tcmx``: the JAX package's PORT=1 archive of it with
every off-by-default mechanism the portable profile allows and JVAL=2)
cannot go stale: the JAX package re-encodes the input at chip_smoke's
config on the CPU to the same bytes, and the input is still what
``make_gated_input`` makes.

To rewrite both files after a deliberate format change:
``PYTHONPATH=. python tests/torch_parity.py --write-gated-fixture``."""

import chip_smoke
from cmix_tpu_torch import engine as te
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils.profiling import GATED_PORT
from torch_parity import gated_fixture, make_gated_input


def test_gated_fixture_archive_is_the_jax_packages_encode():
    data, arc = gated_fixture()
    assert data == make_gated_input()
    with open(chip_smoke.GATED_ARCHIVE, "rb") as f:
        assert f.read() == arc
    off = 4 + runner._HDR_LEN
    glen = int.from_bytes(arc[off:off + 2], "little")
    assert arc[off + 2:off + 2 + glen] == te.make_gates(dict(
        GATED_PORT, X86X=2, GRID2=1, JPEGX=1, JVAL=2)).blob()
