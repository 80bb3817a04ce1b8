"""The media cell, ``cli-media.jpeg-wav.b64``: its configuration, traffic
and readers found by name, every job the whole corpus, and the three
readers of the program's JPEG recode spans, routed part and counters on
Meters built by hand: a number where the program recorded one, nothing
where it recorded none (a program before them, as the parent commit is)."""

import collections
import os

import pytest

from portbench.harness import spec
from portbench.harness.traffic import Jobs
from portbench.metrics import _program_log

CELL = "cli-media.jpeg-wav.b64"
NAMES = ["jpeg_recode_s.enc", "part_ms.routed.enc", "payload_ratio.enc"]
MEDIA = ("testdata/media/grace_hopper.jpg", "testdata/media/signal16.wav")
S = 10**9


def test_the_cell_is_found_by_name():
    cell = spec.Cell(CELL)
    assert cell.chips == 1 and cell.workload["config"] == "cli-media"
    assert [m["name"] for m in cell.per_layer] == NAMES
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and callable(cell.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} == {
        "encode_mib_s", "decode_mib_s", "bpb", "setup_s"}
    cli = spec.load_config("cli")
    assert set(cell.config) == set(cli)
    assert spec.engine_kwargs(cell.config) == dict(
        spec.engine_kwargs(cli), block_size=8192, seg_size=4096,
        lstm_horizon=4)
    assert cell.config["gates"] == {} and cell.config["max_batch"] == 64
    assert list(cell.config["reduced"]) == ["block_size"]
    bench = spec.load_benchmark()
    (entry,) = [c for c in bench["configs"] if c["name"] == "cli-media"]
    assert entry["reduced"] == ["block_size"]
    assert entry["source"] == cell.config["source"]


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -7])
def test_every_job_is_the_whole_corpus(seed):
    cell = spec.Cell(CELL)
    corpus = b""
    for path in MEDIA:
        with open(os.path.join(spec.ROOT, path), "rb") as f:
            corpus += f.read()
    assert len(corpus) == cell.traffic["piece_bytes"] == 112534
    jobs = Jobs(cell.traffic, seed, cell.bench_dir)
    assert all(jobs.job(j) == corpus for j in (0, 1, 5))


@pytest.fixture
def profiling(monkeypatch):
    from cmix_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "CALLS", collections.deque(maxlen=512))
    return profiling


def _meter(profiling, phases, root, spans=(), parts=None, counts=None):
    """One call's Meter with a root span ``root`` of 10 s, its children
    ``spans`` [(name, seconds)] under a ``transform`` span, the groups'
    ``parts`` and the call's ``counts``; logged."""
    m = profiling.Meter()
    m.t = dict(phases)
    m.spans = [profiling.Span(root, 0, 10 * S, None, 0),
               profiling.Span("transform", 0, 5 * S, 0, 0)]
    m.spans += [profiling.Span(n, S, S + int(s * S), 1, 0) for n, s in spans]
    if parts is not None:
        m.part_ms = {0: list(parts)}
    if counts is not None:
        m.counts = {0: dict(counts)}
    profiling.CALLS.append(m)
    return m


def _read(name, ctx):
    return spec.Cell(CELL).reader(name)(ctx)


def _rec(m):
    return {"phases": dict(m.t), "seconds": 10.0}


COUNTS = {"in_bytes": 112534, "payload_bytes": 519309,
          "seg_bytes.jpegc": 468081, "seg_bytes.raw": 44,
          "seg_bytes.audio": 51184, "lanes.jpegc": 57, "lanes.audio": 7}


def test_readers_read_the_programs_records(profiling):
    parts = lambda r: {"predict": 2.0, "routed": r, "coder": 1.5}  # noqa
    e1 = _meter(profiling, {"compile": 0.5, "device": 80.0}, "compress",
                [("jpeg_recode", 0.6)], [parts(0.3)], COUNTS)
    e2 = _meter(profiling, {"compile": 0.6, "device": 81.0}, "compress",
                [("jpeg_recode", 0.8)], [parts(0.5)], COUNTS)
    d1 = _meter(profiling, {"compile": 0.4, "device": 79.0}, "decompress",
                [("jpeg_restore", 2.5)], [parts(9.0)], COUNTS)
    # a decode call's spans and parts are not read by the encode readers;
    # logged but no call of the window (the warm-up): not read
    _meter(profiling, {"compile": 0.1, "device": 0.1}, "compress",
           [("jpeg_recode", 50.0)], [parts(50.0)],
           {"in_bytes": 16, "payload_bytes": 16})
    ctx = {"enc": [_rec(e1), _rec(e2)], "dec": [_rec(d1)]}
    assert _read("jpeg_recode_s.enc", ctx) == pytest.approx(0.7)
    assert _read("part_ms.routed.enc", ctx) == pytest.approx(0.4)
    assert _read("payload_ratio.enc", ctx) == pytest.approx(519309 / 112534)


@pytest.mark.parametrize("how", ["parent", "no_log", "no_match"])
def test_readers_read_nothing_without_the_records(profiling, monkeypatch,
                                                  how):
    """The parent's Meters (spans and the six parts, but no JPEG span, no
    routed part and no counters), a program that logs no Meter, or logged
    Meters of other calls: each reader gives None and none raises."""
    six = {p: 1.0 for p in ("predict", "coder", "update", "state", "lstm",
                            "copyback")}
    e = _meter(profiling, {"compile": 0.5, "device": 80.0}, "compress",
               [("group_state", 0.4)], [six])
    d = _meter(profiling, {"compile": 0.4, "device": 79.0}, "decompress",
               [("group_state", 0.4)], [six])
    del e.counts, d.counts                     # a Meter before counters
    ctx = {"enc": [_rec(e)], "dec": [_rec(d)]}
    if how == "no_log":
        monkeypatch.delattr(profiling, "CALLS")
    elif how == "no_match":
        ctx = {"enc": [{"phases": {"device": 1.0}}],
               "dec": [{"phases": {"device": 2.0}}]}
    for name in NAMES:
        assert _read(name, ctx) is None, name
    assert _program_log.window_meters({"enc": []}) == []
