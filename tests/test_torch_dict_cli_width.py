"""The JAX package's PORT=1 archive of chip_smoke.py's dictionary path
(mini.dic on a text prefix in 128-byte blocks at the runner CLI's widths)
has the sha256 that chip_smoke.py holds the card's archive to, so that
check cannot go stale.  The archive is the committed golden ``dict_cli``;
``RUN_SLOW=1 pytest tests/test_torch_goldens.py`` re-derives it with the
JAX package."""

import hashlib

import chip_smoke
from torch_parity import jax_golden


def test_dict_cli_width_archive_hash_is_the_jax_packages():
    data = chip_smoke._text(chip_smoke.DICT_KIB)
    kw = dict(block_size=chip_smoke.DICT_BLOCK, **chip_smoke.CLI_WIDTHS)
    arc = jax_golden("dict_cli", data, config=kw, gates={"PORT": 1},
                     dictionary=chip_smoke.DICT_FILE)
    assert arc[5] == 3
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.DICT_PORT_SHA256
