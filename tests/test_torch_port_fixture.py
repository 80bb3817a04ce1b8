"""The committed portable fixture that chip_smoke.py holds the card to
(``testdata/portable.raw`` and the JAX package's PORT=1 archive of it,
``testdata/portable.tcmx``, the golden ``portable``) cannot go stale: the
archive is the golden of that input at chip_smoke's config.
``RUN_SLOW=1 pytest tests/test_torch_goldens.py`` re-encodes it with the
JAX package on the CPU.

To rewrite the archive after a deliberate format change:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
--write-goldens portable``."""

import chip_smoke
from torch_parity import jax_golden


def test_fixture_archive_is_the_jax_packages_encode():
    with open(chip_smoke.PORT_FIXTURE, "rb") as f:
        data = f.read()
    assert len(data) == 2000
    arc = jax_golden("portable", data, config=chip_smoke.PORT_SMALL,
                     gates={"PORT": 1}, max_batch=chip_smoke.PORT_BATCH)
    with open(chip_smoke.PORT_ARCHIVE, "rb") as f:
        assert f.read() == arc
