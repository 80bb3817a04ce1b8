"""What the benchmark imports: nothing of the JAX package or JAX (each
module's top-level name compared whole: ``cmix_tpu_torch`` begins with
``cmix_tpu``), nothing of the root's bench, chip_smoke, work/ or tools/;
the reference nothing of the program."""

import ast
import os

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "cmix_tpu", "bench", "chip_smoke",
             "work", "tools"}


def _modules(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _tops(path):
    return {name.split(".")[0] for name in _imports(path)}


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_forbidden_import(path):
    assert not (_tops(path) & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in _modules("reference"):
        assert "cmix_tpu_torch" not in _tops(path), path


def test_only_the_harness_loads_the_program():
    users = {os.path.relpath(p, BENCH_DIR) for p in _modules()
             if "cmix_tpu_torch" in _tops(p)}
    assert {u for u in users if not u.startswith("tests")} == {
        os.path.join("harness", "cell.py")}


def test_top_level_names_compare_whole():
    from portbench.harness.cell import FORBIDDEN as RUN_FORBIDDEN
    import sys
    assert "cmix_tpu_torch" not in RUN_FORBIDDEN
    tops = {m.split(".")[0] for m in sys.modules}
    assert not (tops & set(RUN_FORBIDDEN))
