"""The JAX package's PORT=1 archive of chip_smoke.py's portable path (a
text prefix at the runner CLI's widths) has the sha256 that chip_smoke.py
holds the card's archive to, so that check cannot go stale."""

import hashlib

import chip_smoke
from cmix_tpu import engine as je
from torch_parity import jax_runner_gates


def test_cli_width_archive_hash_is_the_jax_packages():
    data = chip_smoke._text(chip_smoke.PORT_KIB)
    kw = dict(block_size=chip_smoke.PORT_BLOCK, **chip_smoke.CLI_WIDTHS)
    with jax_runner_gates({"PORT": 1}) as jr:
        arc = jr.compress(data, je.EngineConfig(**kw))
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.PORT_CLI_SHA256
