"""The JAX package's PORT=1 archive of the gated fixture at the runner
CLI's widths, with every off-by-default mechanism the portable profile
allows and JVAL=2, has the sha256 that chip_smoke.py holds the card's
archive to (``chip_smoke.GATED_PORT_SHA256``), so that check cannot go
stale."""

import hashlib

import chip_smoke
from cmix_tpu import engine as je
from cmix_tpu_torch.utils.profiling import GATED_PORT
from torch_parity import jax_runner_gates


def test_gated_cli_width_archive_hash_is_the_jax_packages():
    with open(chip_smoke.GATED_FIXTURE, "rb") as f:
        data = f.read()
    kw = dict(block_size=chip_smoke.GATED_PORT_BLOCK, **chip_smoke.CLI_WIDTHS)
    with chip_smoke.EnvVar("JVAL_ROUTE", chip_smoke.JVAL_ROUTE), \
            jax_runner_gates(GATED_PORT) as jr:
        arc = jr.compress(data, je.EngineConfig(**kw))
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.GATED_PORT_SHA256
