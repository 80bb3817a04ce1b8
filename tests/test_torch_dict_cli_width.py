"""The JAX package's PORT=1 archive of chip_smoke.py's dictionary path
(mini.dic on a text prefix in 128-byte blocks at the runner CLI's widths)
has the sha256 that chip_smoke.py holds the card's archive to, so that
check cannot go stale."""

import hashlib

import chip_smoke
from cmix_tpu import engine as je
from cmix_tpu.utils import checkpoint as jck
from torch_parity import jax_runner_gates


def test_dict_cli_width_archive_hash_is_the_jax_packages(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(jck, "CACHE_DIR", str(tmp_path))
    data = chip_smoke._text(chip_smoke.DICT_KIB)
    kw = dict(block_size=chip_smoke.DICT_BLOCK, **chip_smoke.CLI_WIDTHS)
    with jax_runner_gates({"PORT": 1}) as jr:
        arc = jr.compress(data, je.EngineConfig(**kw),
                          dictionary=chip_smoke.DICT_FILE)
    assert arc[5] == 3
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.DICT_PORT_SHA256
