"""``--stats`` and ``--profile`` on the port's CLI, and their tools
(``utils/profiling.py``: Meter, Progress, trace), as the JAX package's
(tests/test_distributed.py, cmix_tpu/runner.py main)."""

import json
import os

import torch_parity
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils.profiling import Meter, Progress, trace


def test_meter_report():
    m = Meter()
    with m.phase("compile"):
        pass
    with m.phase("device"):
        sum(range(1000))
    m.add_segment(4096)
    m.bytes, m.out_bytes = 4096, 1024
    r = m.report({"mode": "test"})
    assert r["segments"] == 1 and r["bpb"] == 2.0 and r["mode"] == "test"
    assert "compile" in r["phases_s"] and r["mb_s"] > 0


def test_progress_and_trace_noop(capsys):
    p = Progress(100, interval=0.0)
    p.update(50)
    p.update(100)
    assert "100.00%" in capsys.readouterr().err
    with trace(None):
        pass


def _report(err):
    return json.loads(err.strip().splitlines()[-1])


def test_stats_reports_the_jax_packages_keys(tmp_path, capsys):
    """The same small input through both CLIs on the CPU: one JSON line
    on stderr each way, with the same keys and phases; the port's counts
    every segment and the archive's bits per byte."""
    from cmix_tpu import runner as jr
    src = tmp_path / "in.txt"
    with open("testdata/text100k.raw", "rb") as f:
        src.write_bytes(f.read()[:128])
    widths = ["--block-size", "64", "--tbits", "10", "--lstm", "16",
              "--dmc", "4096", "--stats"]
    reports = {}
    for name, main, extra in (("jax", jr.main, []),
                              ("port", runner.main, ["--device", "cpu"])):
        with torch_parity.jax_runner_gates({}):
            main(["c", str(src), str(tmp_path / f"{name}.tcmx")] + widths
                 + extra)
        reports[name] = _report(capsys.readouterr().err)
        main(["d", str(tmp_path / f"{name}.tcmx"), str(tmp_path / name),
              "--stats"] + extra)
        reports[name + " d"] = _report(capsys.readouterr().err)
        assert (tmp_path / name).read_bytes() == src.read_bytes()
    for mode in ("", " d"):
        jax_r, port_r = reports["jax" + mode], reports["port" + mode]
        assert set(port_r) == set(jax_r)
        assert set(port_r["phases_s"]) == set(jax_r["phases_s"])
        assert port_r["mode"] == jax_r["mode"]
        assert port_r["bytes"] == jax_r["bytes"] == 128
        # one group of two lanes, one segment per block
        assert port_r["segments"] == jax_r["segments"] == 1
    arc = (tmp_path / "port.tcmx").read_bytes()
    assert reports["port"]["out_bytes"] == len(arc)
    assert reports["port"]["bpb"] == round(8.0 * len(arc) / 128, 4)


def test_profile_writes_a_trace(tmp_path, capsys):
    src, prof = tmp_path / "in.txt", tmp_path / "prof"
    src.write_bytes(b"abcd")
    runner.main(["c", str(src), str(tmp_path / "a.tcmx"), "--device", "cpu",
                 "--block-size", "4", "--tbits", "10", "--lstm", "8",
                 "--dmc", "4096", "--profile", str(prof)])
    assert "compile" in _report(capsys.readouterr().err)["phases_s"]
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
