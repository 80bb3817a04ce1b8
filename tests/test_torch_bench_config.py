"""The port's bench configuration and corpus (``cmix_tpu_torch/bench.py``)
against what ``bench.py`` codes, read from its source: ``bench_config({})``
is bench.py's ``EngineConfig`` call and ``update_gates`` mapping with every
switch at its default, each of bench.py's switches reaches its field or
gate, the environment's gates reach the bench's, and the corpus is the
repo's 4 MiB ``testdata/bench4m.raw`` (a missing or short file raises).  No
JAX compile."""

import ast
import dataclasses
import os

import pytest

from cmix_tpu_torch import bench
from cmix_tpu_torch.engine import BENCH_GATES, EngineConfig, make_gates

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _switch(node):
    """(name, default) of ``int(os.environ.get(NAME, DEFAULT))``, else
    None."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "int" and isinstance(node.args[0], ast.Call)
            and ast.unparse(node.args[0].func) == "os.environ.get"):
        name, default = node.args[0].args
        return name.value, default.value
    return None


def _bench_py():
    """bench.py's config as its source codes it: ({field: value},
    {gate: default}, {switch: (field or gate, default)})."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fields, gates, switches = {}, {}, {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "EngineConfig":
            for kw in node.keywords:
                sw = _switch(kw.value)
                if sw:
                    switches[sw[0]] = (kw.arg, sw[1])
                    fields[kw.arg] = sw[1]
                else:
                    fields[kw.arg] = eval(compile(ast.Expression(kw.value),
                                                  "bench.py", "eval"),
                                          {"__builtins__": {}})
        elif ast.unparse(node.func) == "_engine.update_gates":
            for k, v in zip(node.args[0].keys, node.args[0].values):
                name, default = _switch(v)
                switches[name] = (k.value, default)
                gates[k.value] = default
    return fields, gates, switches


def test_bench_config_is_bench_pys():
    fields, gates, switches = _bench_py()
    assert len(switches) == 7 and len(gates) == 5
    cfg, got = bench.bench_config({})
    assert cfg == EngineConfig(**fields)
    assert got == gates == BENCH_GATES
    assert (cfg.block_size, cfg.seg_size, cfg.dmc_nodes) == (16384, 2048,
                                                             16384)


@pytest.mark.parametrize("switch", ["BDMC_L", "BPPM_CK", "BPPM_DEEP",
                                    "BBANK_CH", "BCTX4", "BDMC_N",
                                    "BLSTM_WIN"])
def test_each_switch_moves_its_field_or_gate(switch):
    fields, gates, switches = _bench_py()
    target, default = switches[switch]
    cfg, got = bench.bench_config({switch: str(default + 1)})
    if target in gates:
        assert got == dict(gates, **{target: default + 1})
        assert cfg == EngineConfig(**fields)
    else:
        assert got == gates
        assert cfg == dataclasses.replace(EngineConfig(**fields),
                                          **{target: default + 1})


def test_the_environments_gates_reach_the_bench():
    cfg, gates = bench.bench_config({"PORT": "1", "DMC_LEVELS": "5",
                                     "SSE2": "1", "HOME": "/x"})
    # the bench gates override the environment's, as update_gates does
    assert gates == dict(BENCH_GATES, PORT="1", SSE2="1")
    g = make_gates(gates)
    assert g.port and g.sse2 == 1 and g.dmc_levels == 7
    assert bench.bench_config({"PORT": "1", "BDMC_L": "5"})[1][
        "DMC_LEVELS"] == 5


def test_corpus_is_the_repos_bench4m():
    assert os.path.commonpath([bench.CORPUS, ROOT]) == ROOT
    data = bench.corpus()
    assert len(data) == 4 << 20
    with open(os.path.join(ROOT, "testdata", "bench4m.raw"), "rb") as f:
        assert data == f.read()
    assert len(bench.corpus(1)) == 1 << 20


def test_a_missing_or_short_corpus_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "CORPUS", str(tmp_path / "bench4m.raw"))
    with pytest.raises(FileNotFoundError):
        bench.corpus()
    (tmp_path / "bench4m.raw").write_bytes(bytes(range(256)) * 4096)
    with pytest.raises(ValueError):
        bench.corpus()
    assert len(bench.corpus(1)) == 1 << 20
