"""The port's bench command line (``cmix_tpu_torch/bench.py`` ``main``) on
the CPU, on a tiny input at small widths (``corpus`` and ``bench_config``
patched): stdout is exactly one JSON line with ``bench.py``'s four keys and
a positive value, stderr carries the log lines and both timed passes'
Meter reports; a stream corrupted before the decode gives ``bench.py``'s
zero line and exit status 1.  Port only: no JAX compile."""

import json
import re

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import bench
from cmix_tpu_torch.engine import BENCH_GATES, EngineConfig
from torch_parity import RUNNER_KW

# 64 lanes of 32 B, two segments a block: enough lanes that the rate
# rounds to a positive value at 4 places on a CPU
TINY_KW = dict(RUNNER_KW, block_size=32, seg_size=16)


@pytest.fixture
def tiny(monkeypatch):
    raw = np.frombuffer(bench.corpus(), np.uint8).reshape(256, -1)
    data = raw[::4, :TINY_KW["block_size"]].tobytes()
    monkeypatch.setattr(bench, "corpus", lambda: data)
    monkeypatch.setattr(bench, "bench_config",
                        lambda: (EngineConfig(**TINY_KW), dict(BENCH_GATES)))
    return monkeypatch


def _meters(err):
    return {line.split(":", 1)[0]: json.loads(line.split(":", 1)[1])
            for line in err.splitlines() if line.startswith("meter ")}


def test_main_prints_one_json_line(tiny, capsys):
    assert bench.main(["--device", "cpu"]) == 0
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert res["value"] > 0 and res["unit"] == "MB/s"
    # bench.py's ratio, of the unrounded rate
    assert abs(res["vs_baseline"] - res["value"] / bench.BASELINE_MB_S) \
        <= 0.05 + 0.00005 / bench.BASELINE_MB_S
    assert "roundtrip ok" in res["metric"] and "bpb=" in res["metric"]
    assert "encode compile+first:" in cap.err
    assert "roundtrip: True" in cap.err
    assert re.search(r"^streams sha256: [0-9a-f]{64}$", cap.err, re.M)
    meters = _meters(cap.err)
    assert set(meters) == {"meter encode", "meter decode"}
    for label in ("encode", "decode"):
        m = meters[f"meter {label}"]
        assert m["mode"] == label and m["segments"] == 2
        assert m["bytes"] == 64 * TINY_KW["block_size"]
        assert m["out_bytes"] > 0 and {"device", "host"} <= set(m["phases_s"])


def test_a_failed_round_trip_prints_zero_and_exits_1(tiny, capsys):
    streams = bench._streams

    def corrupt(out, out_len):
        comp = streams(out, out_len)
        comp[0, 4] ^= 0xFF                   # past the coder's first word
        return comp
    tiny.setattr(bench, "_streams", corrupt)
    assert bench.main(["--device", "cpu"]) == 1
    cap = capsys.readouterr()
    assert json.loads(cap.out) == {"metric": "encode+decode MB/s/chip",
                                   "value": 0.0, "unit": "MB/s",
                                   "vs_baseline": 0.0}
    assert len(cap.out.splitlines()) == 1
    assert "roundtrip: False" in cap.err
