"""The Meter's spans and device records (``utils/profiling.py``) and the
spans that ``runner.compress``/``decompress`` and the transcoder open, on
the CPU at tiny widths.  The device records (each replay's device ms, the
step's six parts) come only from the captured graph: on the eager step
they stay empty here, and ``tests/test_torch_cuda.py`` holds them on the
card."""

import json
import os

import pytest
import torch

from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils import checkpoint, profiling
from cmix_tpu_torch.utils.profiling import CALLS, Meter

# no LSTM and no DMC: the smallest step, the spans are the same
CFG = E.EngineConfig(block_size=4, tbits=10, lstm_hidden=0, dmc_nodes=0)
DATA = b"the cat and the hat"
# a transcoder call's spans, in the order they open (one segment a group)
TRANSCODE = ["transcode", "capture", "enqueue", "wait", "compact",
             "readback"]


@pytest.fixture(scope="module")
def dic(tmp_path_factory):
    """A one-word dictionary: pretraining replays one segment."""
    path = tmp_path_factory.mktemp("dic") / "one.dic"
    path.write_bytes(b"the\n")
    return str(path)


def _names(m):
    return [s.name for s in m.spans]


def test_spans_nest_with_parents_and_one_call_id():
    m = Meter()
    n0 = len(CALLS)
    with m.call("outer"):
        with m.span("a"):
            with m.span("b", "device"):
                pass
        with m.span("c", "host"):
            pass
    with m.span("second"):
        pass
    assert _names(m) == ["outer", "a", "b", "c", "second"]
    assert [s.parent for s in m.spans] == [None, 0, 1, 0, None]
    assert [s.call for s in m.spans] == [0, 0, 0, 0, 1]
    assert [s.phase for s in m.spans] == [None, None, "device", "host",
                                          None]
    outer, a, b, c, _ = m.spans
    assert outer.start_ns <= a.start_ns <= b.start_ns <= b.end_ns
    assert b.end_ns <= a.end_ns <= c.start_ns <= c.end_ns <= outer.end_ns
    assert set(m.t) == {"device", "host"}
    # only a call's root logs the Meter, once it ends; the log is bounded
    assert len(CALLS) == n0 + 1 and CALLS[-1] is m
    assert CALLS.maxlen == profiling.CALLS_KEPT == 512


def test_a_failed_call_is_not_logged():
    m, n0 = Meter(), len(CALLS)
    with pytest.raises(ValueError):
        with m.call("compress"):
            raise ValueError("no")
    assert len(CALLS) == n0 and m.spans[0].end_ns is not None


def test_span_start_agrees_with_the_profilers_event():
    """A span's stamps are on the clock of torch.profiler's events: the
    record_function the span enters is within 1 ms of it at both ends."""
    m = Meter()
    with m.span("warm"):                 # the first record_function's cost
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with m.span("spans_probe"):
            torch.ones(16).sum()
    evt = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "spans_probe"]
    assert len(evt) == 1
    span = m.spans[-1]
    assert abs(evt[0].start_ns() - span.start_ns) < 1e6
    assert abs(evt[0].end_ns() - span.end_ns) < 1e6


def _code(data, meter=None, dictionary=None, max_batch=2):
    return runner.compress(data, CFG, max_batch=max_batch, device="cpu",
                           meter=meter, dictionary=dictionary)


@pytest.fixture(scope="module")
def coded(dic, tmp_path_factory):
    """DATA coded with the dictionary in groups of two lanes, without a
    Meter and with one, and the archive decoded with one -> (archive,
    the encode's Meter, the decode's Meter)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint, "CACHE_DIR",
                   str(tmp_path_factory.mktemp("cache")))
        arc = _code(DATA, dictionary=dic)
        enc, dec = Meter(), Meter()
        assert _code(DATA, enc, dic) == arc
        assert runner.decompress(arc, dictionary=dic, device="cpu",
                                 meter=dec) == DATA
    return arc, enc, dec


def _group(i):
    return ["group_state", "transcode", "copyin" if i else "capture"] \
        + TRANSCODE[2:]


def test_runner_opens_every_span_in_order(coded):
    """Each group's state and transcoder call under the call's root (the
    graph or eager step built at the first group, copied into at the
    next), the dictionary's base before them, the container last on
    encode and first on decode; both calls logged."""
    _, enc, dec = coded
    n = _names(enc).count("group_state")
    assert n >= 2 and _names(dec).count("group_state") == n
    groups = [x for i in range(n) for x in _group(i)]
    assert _names(enc) == (["compress", "transform", "route", "pretrain"]
                           + groups + ["container"])
    assert _names(dec) == (["decompress", "container", "pretrain"]
                           + groups + ["transform"])
    for m in (enc, dec):
        spans = m.spans
        assert {s.call for s in spans} == {0}
        for s in spans[1:]:
            under = spans[s.parent].name
            assert under == ("transcode" if s.parent and under == "transcode"
                             else spans[0].name), s
        assert [s.name for s in spans if s.parent
                and spans[s.parent].name == "transcode"] == [
                    x for x in groups if x not in ("group_state",
                                                   "transcode")]
    assert list(CALLS).index(enc) < list(CALLS).index(dec)


def test_phase_totals_equal_the_sums_of_their_spans(coded):
    for m in coded[1:]:
        assert set(m.t) == {"compile", "device", "host"}
        for phase, total in m.t.items():
            assert total == pytest.approx(
                sum(s.seconds for s in m.spans if s.phase == phase),
                rel=1e-12)
        assert {s.name: s.phase for s in m.spans if s.phase} == {
            "capture": "compile", "copyin": "device", "enqueue": "device",
            "wait": "device", "compact": "host"}


def test_archive_is_the_same_with_and_without_a_meter(coded):
    """Without a dictionary here (the fixture holds the dictionary's
    archive to the Meter's): one group."""
    arc = _code(DATA, max_batch=64)
    assert _code(DATA, Meter(), max_batch=64) == arc
    assert runner.decompress(arc, device="cpu", meter=Meter()) == DATA


def test_eager_step_leaves_the_device_records_empty(coded):
    for m in coded[1:]:
        assert m.replay_ms == {} and m.part_ms == {}
    seg = E.make_segment_fn(CFG, E.make_gates({}), torch.device("cpu"),
                            timed=True)
    assert seg.timer is None and seg.ring is None


def test_profile_writes_the_spans_beside_the_trace(tmp_path, capsys):
    src, prof = tmp_path / "in.txt", tmp_path / "prof"
    src.write_bytes(b"abcd")
    runner.main(["c", str(src), str(tmp_path / "a.tcmx"), "--device", "cpu",
                 "--block-size", "4", "--tbits", "10", "--lstm", "8",
                 "--dmc", "4096", "--profile", str(prof), "--stats"])
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    with open(os.path.join(prof, "spans.json")) as f:
        spans = json.load(f)
    assert [s["name"] for s in spans["spans"]][:2] == ["compress",
                                                       "transform"]
    assert set(spans["phases_s"]) == set(report["phases_s"])
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"compress", "transcode", "enqueue"} <= names
