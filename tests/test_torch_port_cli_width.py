"""The JAX package's PORT=1 archive of chip_smoke.py's portable path (a
text prefix at the runner CLI's widths) has the sha256 that chip_smoke.py
holds the card's archive to, so that check cannot go stale.  The archive
is the committed golden ``port_cli``; ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-derives it with the JAX package."""

import hashlib

import chip_smoke
from torch_parity import jax_golden


def test_cli_width_archive_hash_is_the_jax_packages():
    data = chip_smoke._text(chip_smoke.PORT_KIB)
    kw = dict(block_size=chip_smoke.PORT_BLOCK, **chip_smoke.CLI_WIDTHS)
    arc = jax_golden("port_cli", data, config=kw, gates={"PORT": 1})
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.PORT_CLI_SHA256
