"""The committed portable fixture that chip_smoke.py holds the card to
(``testdata/portable.raw`` and the JAX package's PORT=1 archive of it,
``testdata/portable.tcmx``) cannot go stale: the JAX package re-encodes
the input at chip_smoke's config on the CPU to the same bytes.

To rewrite the archive after a deliberate format change:
``PYTHONPATH=. python tests/torch_parity.py --write-fixture``."""

import chip_smoke
from torch_parity import port_fixture


def test_fixture_archive_is_the_jax_packages_encode():
    data, arc = port_fixture()
    assert len(data) == 2000
    with open(chip_smoke.PORT_ARCHIVE, "rb") as f:
        assert f.read() == arc
