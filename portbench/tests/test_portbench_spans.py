"""The readers of the program's spans and device events
(``metrics/replay_ms.enc.py`` and the others that ``metrics/_program_log``
serves), on Meters of the program built by hand: the match of a logged
Meter to a window's encode call by equal phases, each reader's arithmetic,
and nothing read where there is nothing to read."""

import collections
import sys

import pytest

from portbench.harness.spec import Cell
from portbench.metrics import _program_log

NAMES = ["replay_ms.enc", "replay_ms_p95.enc", "off_step_share.enc",
         "group_state_s.enc"] + [
             f"part_ms.{p}.enc" for p in ("predict", "coder", "update",
                                          "state", "lstm", "copyback")]
S = 10**9


@pytest.fixture
def profiling(monkeypatch):
    from cmix_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "CALLS", collections.deque(maxlen=512))
    return profiling


def _meter(profiling, phases, root_s, groups_s, replays, parts):
    """One call's Meter: a root of ``root_s`` seconds, a group_state span
    of each of ``groups_s``, the replays' device ms and the groups' parts;
    logged."""
    m = profiling.Meter()
    m.t = dict(phases)
    m.spans = [profiling.Span("compress", 0, int(root_s * S), None, 0)]
    for g in groups_s:
        m.spans.append(profiling.Span("group_state", S, S + int(g * S), 0,
                                      0))
    if replays:
        m.replay_ms = {0: list(replays)}
    if parts:
        m.part_ms = {0: list(parts)}
    profiling.CALLS.append(m)
    return m


def _read(name, ctx):
    return Cell("cli.mixed.b64").reader(name)(ctx)


def _ctx(*meters):
    return {"enc": [{"phases": dict(m.t), "seconds": 1.0} for m in meters]}


def _parts(x):
    return {p: x * (i + 1) for i, p in enumerate(
        ("predict", "coder", "update", "state", "lstm", "copyback"))}


def test_readers_match_the_windows_calls_by_their_phases(profiling):
    a = _meter(profiling, {"compile": 0.5, "device": 5.0, "host": 0.01},
               6.0, [0.3], [10.0, 11.0, 12.0], [_parts(1.0)])
    b = _meter(profiling, {"compile": 0.4, "device": 5.1, "host": 0.02},
               7.0, [0.2, 0.1], [9.0, 13.0], [_parts(2.0), _parts(4.0)])
    # logged, but not one of the window's encode calls (a decode, the
    # warm-up, the traced call)
    _meter(profiling, {"compile": 0.1, "device": 1.0, "host": 0.0}, 1.0,
           [5.0], [99.0] * 50, [_parts(50.0)])
    ctx = _ctx(a, b)
    assert _program_log.window_meters(ctx) == [a, b]
    assert _read("replay_ms.enc", ctx) == 11.0
    # numpy's linear percentile of [9, 10, 11, 12, 13]: rank 3.8
    assert _read("replay_ms_p95.enc", ctx) == pytest.approx(12.8)
    # (6 + 7 s of roots) - (33 + 22 ms of replays)
    assert _read("off_step_share.enc", ctx) == pytest.approx(
        100.0 * (13.0 - 0.055) / 13.0)
    assert _read("group_state_s.enc", ctx) == pytest.approx(0.6 / 2)
    # the parts of three groups: x1, x2, x4 -> the median is x2
    for i, p in enumerate(("predict", "coder", "update", "state", "lstm",
                           "copyback")):
        assert _read(f"part_ms.{p}.enc", ctx) == pytest.approx(2.0 * (i + 1))


def test_an_even_count_takes_the_middle_pair():
    assert _program_log.median([4.0, 1.0, 3.0, 2.0]) == 2.5
    assert _program_log.median([]) is None


def test_nothing_read_on_the_eager_step(profiling):
    """Spans but no device events (the CPU's eager step): the device
    readers read nothing, the span reader still reads."""
    m = _meter(profiling, {"compile": 0.5, "device": 5.0, "host": 0.01},
               6.0, [0.25], [], [])
    ctx = _ctx(m)
    for name in NAMES:
        v = _read(name, ctx)
        assert (v == 0.25) if name == "group_state_s.enc" else v is None


@pytest.mark.parametrize("how", ["no_match", "no_log", "not_loaded"])
def test_nothing_read_without_the_programs_records(profiling, monkeypatch,
                                                   how):
    """No logged Meter matches (the window's calls' phases differ), the
    program keeps no log (a program before the spans), or no program
    module is loaded: every reader gives None and none raises."""
    m = _meter(profiling, {"compile": 0.5, "device": 5.0, "host": 0.01},
               6.0, [0.3], [10.0], [_parts(1.0)])
    ctx = _ctx(m)
    if how == "no_match":
        ctx["enc"][0]["phases"] = {"compile": 0.5, "device": 5.0,
                                   "host": 0.02}
    elif how == "no_log":
        monkeypatch.delattr(profiling, "CALLS")
    else:
        monkeypatch.delitem(sys.modules, _program_log.PROFILING)
    for name in NAMES:
        assert _read(name, ctx) is None, name
    assert _read("replay_ms.enc", {"enc": []}) is None
