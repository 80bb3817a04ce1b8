"""The JAX package's PORT=1 archive of the gated fixture at the runner
CLI's widths under ``utils/profiling.LEAN`` has the sha256 that
chip_smoke.py holds the card's archive to
(``chip_smoke.GATES_PORT_SHA256``), so that check cannot go stale.
test_torch_gates_cli_width_knobs.py holds ``KNOBS``'s."""

import hashlib

import chip_smoke
from cmix_tpu import engine as je
from cmix_tpu_torch.utils import profiling
from torch_parity import jax_runner_gates


def check_cli_width_hash(name):
    with open(chip_smoke.GATED_FIXTURE, "rb") as f:
        data = f.read()
    kw = dict(block_size=chip_smoke.GATES_BLOCK, **chip_smoke.CLI_WIDTHS)
    env = dict(getattr(profiling, name.upper()), PORT=1)
    with jax_runner_gates(env) as jr:
        arc = jr.compress(data, je.EngineConfig(**kw))
    assert hashlib.sha256(arc).hexdigest() == chip_smoke.GATES_PORT_SHA256[
        name]


def test_lean_cli_width_archive_hash_is_the_jax_packages():
    check_cli_width_hash("lean")
