"""The JAX package's PORT=1 archive of the routed fixture at the runner
CLI's widths has the sha256 that chip_smoke.py holds the card's archive to
(``chip_smoke.ROUTED_PORT_SHA256``), so that check cannot go stale."""

import hashlib

import chip_smoke
from cmix_tpu import engine as je
from torch_parity import jax_runner_gates


def test_routed_cli_width_archive_hash_is_the_jax_packages():
    with open(chip_smoke.ROUTED_FIXTURE, "rb") as f:
        data = f.read()
    kw = dict(block_size=chip_smoke.ROUTED_PORT_BLOCK, **chip_smoke.CLI_WIDTHS)
    with jax_runner_gates({"PORT": 1}) as jr:
        arc = jr.compress(data, je.EngineConfig(**kw))
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.ROUTED_PORT_SHA256
