"""The JAX package's PORT=1 archive of the routed fixture at the runner
CLI's widths has the sha256 that chip_smoke.py holds the card's archive to
(``chip_smoke.ROUTED_PORT_SHA256``), so that check cannot go stale.  The
archive is the committed golden ``routed_cli``; ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-derives it with the JAX package."""

import hashlib

import chip_smoke
from torch_parity import jax_golden


def test_routed_cli_width_archive_hash_is_the_jax_packages():
    with open(chip_smoke.ROUTED_FIXTURE, "rb") as f:
        data = f.read()
    kw = dict(block_size=chip_smoke.ROUTED_PORT_BLOCK, **chip_smoke.CLI_WIDTHS)
    arc = jax_golden("routed_cli", data, config=kw, gates={"PORT": 1})
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.ROUTED_PORT_SHA256
