"""The JAX package's PORT=1 archive of the gated fixture at the runner
CLI's widths under ``utils/profiling.KNOBS`` has the sha256 that
chip_smoke.py holds the card's archive to (as test_torch_gates_cli_width.py
holds ``LEAN``'s).  The archive is the committed golden ``knobs_cli``;
``RUN_SLOW=1 pytest tests/test_torch_goldens.py`` re-derives it."""

from test_torch_gates_cli_width import check_cli_width_hash


def test_knobs_cli_width_archive_hash_is_the_jax_packages():
    check_cli_width_hash("knobs")
