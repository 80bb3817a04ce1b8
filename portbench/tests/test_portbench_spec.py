"""BENCHMARK.json against the files it names, and the harness finding a
cell's files by name (a later PR adds files and entries only)."""

import json
import os
import shutil

import pytest

from portbench.harness import spec, traffic

BENCH = spec.load_benchmark()


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        conf = spec.load_config(c["name"])
        assert set(c["reduced"]) <= set(conf["reduced"])
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"], BENCH)
        assert cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} == {
            "encode_mib_s", "decode_mib_s", "bpb", "setup_s"}
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
            assert m["moves"] == "encode_mib_s"


def test_names_units_and_bounds_are_well_formed():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_traffic_file_added_is_found_by_name(tmp_path):
    """A later PR's traffic mix: a new file in a copy of portbench/ and a
    new workload entry, and no file edited."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("corpus", "__pycache__"))
    (bench_dir / "corpus").mkdir()
    (bench_dir / "corpus" / "tiny.raw").write_bytes(bytes(range(256)) * 64)
    (bench_dir / "traffic" / "throwaway.b8.json").write_text(json.dumps(
        {"corpus": "corpus/tiny.raw", "lanes": 8, "piece_bytes": 64,
         "fixed_jobs": 1}))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "cli.throwaway.b8", "config": "cli",
         "traffic": "throwaway.b8", "chips": 1, "why": "test"}])
    cell = spec.Cell("cli.throwaway.b8", bench, str(bench_dir))
    assert cell.traffic["lanes"] == 8
    jobs = traffic.Jobs(cell.traffic, 7, str(bench_dir))
    assert len(jobs.job(0)) == 8 * 64
    with pytest.raises(KeyError):
        spec.Cell("no.such.cell", bench, str(bench_dir))
