"""The JAX package's archives that the port's tests compare against, as
committed goldens (testdata/jax_goldens.json; tests/torch_parity.py
``jax_golden`` reads them).

They are sound while ``cmix_tpu`` is frozen: ``test_the_jax_package_is_frozen``
pins a digest of its sources and the jax, jaxlib and numpy versions that
wrote the goldens, and ``test_golden_files_are_the_tables`` holds every file
to its entry.  The pin does not cover the derivation's code in
tests/torch_parity.py (``derive_golden``, ``jax_bench_encode``,
``jax_runner_gates``, ``cli_env``, ``run_cli``) or the environment
(``XLA_FLAGS``): a change to either needs ``--write-goldens`` and then the
slow test below.
``test_golden_is_the_jax_packages`` (slow: ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py``) re-derives each case with the JAX package
on the CPU, the sha256 and length of its archive, and its decode where the
entry asks for one.  After a deliberate change to ``cmix_tpu``:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
--write-goldens``."""

import importlib.metadata
import os

import pytest

import torch_parity as tp

CASES = list(tp.goldens()["cases"])


def test_the_jax_package_is_frozen():
    freeze = tp.goldens()["freeze"]
    assert tp.freeze_digest() == (freeze["sha256"], freeze["files"])
    for name in tp.FROZEN_VERSIONS:
        assert importlib.metadata.version(name) == freeze[name]


def test_golden_files_are_the_tables():
    table = tp.goldens()["cases"]
    files = set()
    for case, e in table.items():
        with open(os.path.join(tp.ROOT, e["file"]), "rb") as f:
            arc = f.read()
        assert (tp.sha256(arc), len(arc)) == (e["sha256"], e["length"]), case
        assert tp.sha256(tp.read_parts(e["input"])) == e["input_sha256"], case
        files.add(e["file"])
    assert len(files) == len(table)
    extra = os.listdir(os.path.join(tp.ROOT, "testdata", "goldens"))
    assert {f"testdata/goldens/{n}" for n in extra} <= files
    assert sum(e["length"] for e in table.values()) < 1 << 20


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES)
def test_golden_is_the_jax_packages(case, tmp_path):
    e = tp.goldens()["cases"][case]
    data = tp.read_parts(e["input"])
    assert tp.sha256(data) == e["input_sha256"]
    arc, back = tp.derive_golden(e, str(tmp_path))
    assert (tp.sha256(arc), len(arc)) == (e["sha256"], e["length"])
    if e["decode"] is not None:
        assert back == data
