"""The JAX package's PORT=1 archive of the gated fixture at the runner
CLI's widths, with every off-by-default mechanism the portable profile
allows and JVAL=2, has the sha256 that chip_smoke.py holds the card's
archive to (``chip_smoke.GATED_PORT_SHA256``), so that check cannot go
stale.  The archive is the committed golden ``gated_cli``; ``RUN_SLOW=1
pytest tests/test_torch_goldens.py`` re-derives it with the JAX
package."""

import hashlib

import chip_smoke
from cmix_tpu_torch.utils.profiling import GATED_PORT
from torch_parity import jax_golden


def test_gated_cli_width_archive_hash_is_the_jax_packages():
    with open(chip_smoke.GATED_FIXTURE, "rb") as f:
        data = f.read()
    kw = dict(block_size=chip_smoke.GATED_PORT_BLOCK, **chip_smoke.CLI_WIDTHS)
    arc = jax_golden("gated_cli", data, config=kw, gates=GATED_PORT,
                     env={"JVAL_ROUTE": chip_smoke.JVAL_ROUTE})
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.GATED_PORT_SHA256
