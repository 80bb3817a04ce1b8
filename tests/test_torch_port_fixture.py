"""The committed portable fixture that chip_smoke.py holds the card to
(``testdata/portable.raw`` and the JAX package's PORT=1 archive of it,
``testdata/portable.tcmx``, the golden ``portable``): 2000 bytes of input,
and the archive carries the case's gates.  ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-encodes it with the JAX package on the
CPU.

To rewrite the archive after a deliberate format change:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
--write-goldens portable``."""

from cmix_tpu_torch import engine as te
from cmix_tpu_torch import runner
from golden_cases import read_case


def test_fixture_archive_is_the_jax_packages_encode():
    e, data, _, arc = read_case("portable")
    assert len(data) == 2000
    off = 4 + runner._HDR_LEN
    glen = int.from_bytes(arc[off:off + 2], "little")
    assert arc[off + 2:off + 2 + glen] == te.make_gates(e["gates"]).blob()
