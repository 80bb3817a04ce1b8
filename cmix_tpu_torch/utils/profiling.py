"""Tracing, metering and progress (the CLI's ``--profile``/``--stats``),
and where a byte step's time goes on the GPU.

Port of cmix_tpu/utils/profiling.py (``trace``, ``Meter``, ``Progress``):

* ``trace(dir, meter)``: a ``torch.profiler`` trace (CPU, and CUDA where
  there is a card) written into ``dir`` as a Chrome trace, ``trace.json``,
  and the meter's spans and counters beside it, ``spans.json``
  (``--profile DIR``);
* ``Meter``: per-phase wall time and bytes, the one-line JSON report
  (``--stats``) with the JAX package's keys; the transcoder waits on the
  device inside its ``device`` phase, where the JAX package's
  ``np.asarray`` blocks;
* ``Progress``: the rate-limited percentage ticker on stderr.

Beyond the JAX package's report a Meter records (none of it goes into
the report or ``Meter.t``):

* spans: ``with meter.span(name):`` records the name, the start and end
  (``time.time_ns()``, the Unix-epoch clock on which ``torch.profiler``
  stamps its events) and the parent span, and enters a
  ``torch.profiler.record_function`` of the same name, so a trace taken
  meanwhile carries the program's spans.  A span opened with no span open
  begins a call (``Span.call``); ``meter.call(name)`` opens such a root and
  logs the Meter in ``CALLS`` when it ends.  Each phase is a span too:
  ``span(name, phase)`` adds its seconds to ``t[phase]``.  The spans of a
  ``runner.compress``/``decompress`` call:

      compress | decompress                      (the call, one per call)
        container      header, segment table, length table (decode: and
                       the gate record and dictionary check)
        transform      wrt.transform (decode: wrt.untransform)
        route          _routed_gates and make_gates (encode)
        pretrain       the dictionary's pretrained base, with one
        group_state    a coding group's initial state, per group
        transcode      engine.make_transcoder's call, per group
          capture      the graph's warm-up and capture (phase compile)
          copyin       a later group copied into the graph (phase device)
          enqueue      a segment's replays and pinned copies (device)
          wait         the wait on a segment's copies (device)
          compact      its compaction on the host (phase host)
          readback     the final coder and history brought to the host

  ``transform`` holds ``jpeg_recode`` (encode) or ``jpeg_restore``
  (decode) around each recoded JPEG's coefficient planes.

* ``replay_ms``: {call: [device ms of each graph replay]}, from a timing
  event on the stream before a segment's first replay and one after each
  replay (``engine._Segments``), read when the segment drains;
* ``part_ms``: {call: [{part: device ms}]}, one record a coding group: the
  six parts of its last replay (``engine.PARTS``: predict, coder, update,
  state, lstm, copyback), timed by event nodes captured in the graph; with
  GRID2, JPEGX or LMS on also ``routed`` (``engine.ROUTED``), the routed
  work's device ms, taken out of the parts it runs in;
* ``counts``: {call: {name: n}}, the call's counters (``count``):
  ``runner.compress``/``decompress`` count ``in_bytes``, ``payload_bytes``,
  ``seg_bytes.<kind>`` (payload bytes by segment kind) and
  ``lanes.<kind>`` (real lanes by block kind), the kinds named as
  ``runner.SEG_KINDS`` (``wrt``'s ``SEG_*`` names, lowercased).

Both device records stay empty on the eager step.  The counters go into
``spans.json`` and the ``--stats`` report (``counts``, summed over the
Meter's calls).  ``CALLS`` holds the Meters of the last ``CALLS_KEPT``
finished ``compress``/``decompress`` calls that were given one; nothing is
written unless ``--profile`` asks.

The byte-step profiler (not in the JAX package):

    python -m cmix_tpu_torch.utils.profiling [--batch 256] [--steps 8]
        [--gates bench|bench-x86|default|routed|portable|wrtw|gated|
        gated-portable] [--widths bench|cli]

runs the byte step of the bench speed profile (bench widths, or the
runner CLI's, on the blocks of ``testdata/bench4m.raw``), or of another
gate set:
the bench set with X86X=2 (what the runner routes for bench4m.raw, whose
detector finds x86 code), the default gates, the default gates with the
media and JPEG routes (GRID2=1, LMS=2, JPEGX=1; every block marked as
24-bit image, so the LMS votes), the portable profile (PORT=1 on the
default gates), the default gates with WRTW=1 (what the runner routes
for a dictionary-coded archive: the WRT codeword tracker), or every
off-by-default mechanism the port runs (``GATED``, ``GATED_PORT``) with
JPEGX, GRID2 and JVAL=2, in either profile, as the
transcoder runs it: ``engine.make_segment_fn``'s captured CUDA graph, then
the eager step (``graph=False``).  Each runs one segment of ``--steps``
steps to warm up (the graph's capture included), times one more on the
host clock (synchronised), then traces a third with CPU and CUDA
activities (the tracer slows the host and the graph's launches, so the
traced wall is printed apart) and prints one JSON line: wall ms per step,
device busy ms per step (the sum of the device's kernel, copy and fill
times on the one stream, from the trace), the graph's median replay ms
and its parts' ms (the six, and ``routed`` under the routed gate sets;
the timed segment's events; None on the eager step), host operator calls
and kernel launches per step, kernels run on the device per step, the top
operators by host time and the top kernels by device time, and always the
two DMC kernels' launches and device ms per step (``dmc_kernels``, zero
where the step launched none).  Needs a CUDA device; the numbers are the
card's, printed beside its name.
"""

import argparse
import collections
import contextlib
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from cmix_tpu_torch import engine as E

# the Meters of the last CALLS_KEPT finished compress/decompress calls
CALLS_KEPT = 512
CALLS = collections.deque(maxlen=CALLS_KEPT)


@contextlib.contextmanager
def trace(log_dir, meter=None):
    """A torch.profiler trace written to ``log_dir`` as a Chrome trace
    (``trace.json``), and ``meter``'s spans and counters beside it
    (``spans.json``); a no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    act = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        act.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=act) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    if meter is not None:
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump(meter.export(), f)


class Span(NamedTuple):
    """One span: ``start_ns``/``end_ns`` on ``time.time_ns()`` (end None
    while open), ``parent`` the index of the enclosing span in
    ``Meter.spans`` (None for a call's root), ``call`` the call's id,
    ``phase`` the phase its seconds count to (or None)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int
    phase: str = None

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9


class Meter:
    """Accumulates per-phase wall time + processed bytes, and the spans and
    device events the module's docstring lists.

    phases: 'compile' (the graph's warm-up and capture), 'device' (the
    segments and the waits on the device), 'host' (compaction).  Report:
    MB/s overall and device-only."""

    def __init__(self):
        self.t = {}
        self.bytes = 0
        self.out_bytes = 0
        self.segments = 0
        self.spans = []
        self.replay_ms = {}
        self.part_ms = {}
        self.counts = {}
        self._open = []
        self._calls = 0

    @contextlib.contextmanager
    def span(self, name, phase=None):
        """Time the block as a span ``name`` inside the innermost open one
        (a new call's root where none is open); with ``phase`` its seconds
        are added to ``t[phase]``."""
        parent = self._open[-1] if self._open else None
        if parent is None:
            call, self._calls = self._calls, self._calls + 1
        else:
            call = self.spans[parent].call
        i = len(self.spans)
        start = time.time_ns()
        self.spans.append(Span(name, start, None, parent, call, phase))
        self._open.append(i)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            end = time.time_ns()
            self._open.pop()
            self.spans[i] = self.spans[i]._replace(end_ns=end)
            if phase is not None:
                self.t[phase] = self.t.get(phase, 0.0) + (end - start) / 1e9

    def phase(self, name):
        return self.span(name, name)

    @contextlib.contextmanager
    def call(self, name):
        """A call's root span; the Meter is logged in ``CALLS`` when the
        call ends without an error."""
        with self.span(name):
            yield
        CALLS.append(self)

    def _call_id(self):
        return self.spans[self._open[-1]].call if self._open else None

    def add_replays(self, ms):
        """Device ms of graph replays, in order, for the open call."""
        self.replay_ms.setdefault(self._call_id(), []).extend(ms)

    def add_parts(self, parts):
        """{part: device ms} of a coding group's last replay."""
        self.part_ms.setdefault(self._call_id(), []).append(parts)

    def count(self, name, n):
        """Add ``n`` to the open call's counter ``name``."""
        c = self.counts.setdefault(self._call_id(), {})
        c[name] = c.get(name, 0) + int(n)

    def export(self):
        """The spans and counters as one JSON-ready dict (``spans.json``)."""
        return {"spans": [s._asdict() for s in self.spans],
                "replay_ms": {str(k): v for k, v in self.replay_ms.items()},
                "part_ms": {str(k): v for k, v in self.part_ms.items()},
                "counts": {str(k): v for k, v in self.counts.items()},
                "phases_s": dict(self.t), "bytes": self.bytes,
                "out_bytes": self.out_bytes, "segments": self.segments}

    def add_segment(self, n_bytes):
        self.segments += 1
        self.bytes += n_bytes

    def report(self, extra=None):
        total = sum(self.t.values())
        dev = self.t.get("device", 0.0)
        counts = collections.Counter()
        for c in self.counts.values():
            counts.update(c)
        r = {
            "bytes": self.bytes,
            "out_bytes": self.out_bytes,
            "segments": self.segments,
            "wall_s": round(total, 3),
            "phases_s": {k: round(v, 3) for k, v in self.t.items()},
            "mb_s": round(self.bytes / max(total, 1e-9) / 2**20, 5),
            "device_mb_s": round(self.bytes / max(dev, 1e-9) / 2**20, 5),
            "counts": dict(counts),
        }
        if self.bytes and self.out_bytes:
            r["bpb"] = round(8.0 * self.out_bytes / self.bytes, 4)
        if extra:
            r.update(extra)
        return r

    def print_report(self, **extra):
        print(json.dumps(self.report(extra or None)), file=sys.stderr,
              flush=True)


class Progress:
    """Rate-limited progress ticker (cf. runner.cpp:111-115)."""

    def __init__(self, total, label="progress", interval=0.5):
        self.total = max(total, 1)
        self.label = label
        self.interval = interval
        self._last = 0.0

    def update(self, done):
        now = time.time()
        if now - self._last >= self.interval or done >= self.total:
            self._last = now
            pct = 100.0 * done / self.total
            print(f"\r{self.label}: {pct:.2f}%", end="",
                  file=sys.stderr, flush=True)
            if done >= self.total:
                print(file=sys.stderr)


# ------------------------------------------------- the byte-step profiler

# the device functions of csrc/dmc_fused.cu and csrc/dmc_counts.cu, found
# by name among the profiler's events
DMC_KERNELS = ("dmc_fused_kernel", "dmc_counts_kernel")
# every off-by-default mechanism the port runs, on the default gates of
# the fast profile, and of the portable one (without those its rules
# exclude); JVAL runs with JPEGX, routed with it by JVAL_ROUTE
GATED = {"SSE2": 1, "APM3X": 1, "MIX_DYN4": 1, "MIX_KIND": 1, "MIX_AUX": 1,
         "SBANK_ADAPT": 1, "VMATCH": 1, "APM_FIXED": 1, "MIX_TAU": 1024.0,
         "MIX_BOOST": 2.0, "MIX_BOOST_N": 64.0}
GATED_PORT = dict({k: v for k, v in GATED.items()
                   if k in ("SSE2", "APM3X", "MIX_DYN4", "MIX_KIND",
                            "MIX_AUX", "APM_FIXED")}, PORT=1)
# two sets of the remaining gate values: LEAN switches the default-on
# components off together, KNOBS moves the value knobs together (shorter
# order lists, a state-bank column list without the order-2 column 1; a
# lower mixer rate, since under MIX_NORM=0 the mixers' steps are sums over
# the blocks: at 6e-3 the PORT=1 archive of testdata/gated.raw outgrew its
# input, 4477 B of 4302, at 1e-3 it is 3458 B)
LEAN = {"WIKI": 0, "MATCH2": 0, "RUNX": 0, "MIX2X": 0, "APM2X": 0,
        "STEMX": 0, "CTX2": 0, "CTX3": 0, "CTX4": 0, "BANK_CK": 0,
        "PPM_EXCL": 0, "PPM_UPD": 0, "PPM_CK": 0, "PPM_DEEP": 0,
        "MIX_DYN2": 0, "MIX_DYN3": 0, "W_APM_LEARN": 0}
KNOBS = {"BANK_CK": 1, "BANK_CH": 2, "MIX_NORM": 0, "STAT_NORM": 0,
         "MIX_LR": 1e-3, "CNT_CAP": 30, "CMIX_N_IND": 4, "RUNX_N": 16,
         "DMC_LEVELS": 4, "CMIX_MATCH_ORDERS": "2,4,8,16,100",
         "CMIX_PPM_ORDERS": "1,2,3,5,8,16",
         "CMIX_SBANK_COLS": "0,2,3,5,10,14,24"}
_JPEG_ROUTES = {"JPEGX": 1, "GRID2": 1, "JVAL": 2}
GATE_SETS = {"bench": E.BENCH_GATES,
             "bench-x86": dict(E.BENCH_GATES, X86X=2),
             "default": {},
             "routed": {"GRID2": 1, "LMS": 2, "JPEGX": 1},
             "portable": {"PORT": 1},
             "wrtw": {"WRTW": 1},
             "gated": dict(GATED, **_JPEG_ROUTES),
             "gated-portable": dict(GATED_PORT, **_JPEG_ROUTES),
             "lean": LEAN, "knobs": KNOBS}
# the byte step's widths: bench.py's, or the runner CLI's (tbits 18, mbits
# 20, pbits 20, LSTM 256, 16384 DMC nodes) at its 16384-byte block
WIDTHS = {"bench": dict(tbits=18, mbits=18, ibits=16),
          "cli": dict(tbits=18, mbits=20, ibits=16, pbits=20)}
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cudaGraphLaunch")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _dev_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _on_device(evt):
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def profile_steps(batch=256, steps=8, gates="bench", graph=True,
                  widths="bench"):
    """Profile ``steps`` byte steps at ``widths`` (``WIDTHS``) as the
    transcoder runs them (one segment of ``steps`` after one of warm-up,
    timed, then one traced) -> the JSON-ready dict the module's docstring
    lists.  The graph's ``replay_ms`` (the median of the timed segment's
    replays) and ``part_ms`` (its last replay's parts) come from the
    device's events; the traced busy time is the tracer's, whose replays
    run slower than untraced ones, so no idle share is formed from the
    two."""
    dev = E.resolve_device("cuda")
    g = E.make_gates(GATE_SETS[gates])
    cfg = E.EngineConfig(block_size=16384, lstm_hidden=256, seg_size=steps,
                         dmc_nodes=16384, lstm_horizon=4, **WIDTHS[widths])
    raw = np.fromfile(os.path.join(_ROOT, "testdata", "bench4m.raw"),
                      dtype=np.uint8)
    lanes = raw[:batch * (len(raw) // batch)].reshape(batch, -1)
    inp = torch.as_tensor(lanes[:, :3 * steps].T.copy(), device=dev)
    pb = E.init_perblock(cfg, g, batch, dev)
    if g.lms:
        pb["blk_kind"].fill_(3)
    seg = E.make_segment_fn(cfg, g, dev, graph, timed=True)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        t0 = time.time()
        seg.start(E.init_shared(cfg, g, dev), pb, E.init_coder(batch, dev),
                  torch.zeros((batch, cfg.comp_size), dtype=torch.uint8,
                              device=dev),
                  torch.zeros(batch, dtype=torch.int64, device=dev))
        seg.run(inp[:steps])
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        t0 = time.time()
        seg.run(inp[steps:2 * steps])
        torch.cuda.synchronize()
        wall = time.time() - t0
        replay_ms = part_ms = None
        if seg.ring is not None:
            replay_ms = float(np.median(seg.replay_ms(seg.ring)))
            part_ms = seg.timer.ms()
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.time()
            seg.run(inp[2 * steps:])
            torch.cuda.synchronize()
            traced = time.time() - t0
    avg = prof.key_averages()
    # the device's own events (kernels, copies, fills); an operator's
    # entry carries its kernels' time too, so summing every entry would
    # count each kernel twice
    dev_evts = [e for e in avg if _on_device(e) and _dev_us(e) > 0]
    busy_us = sum(_dev_us(e) for e in dev_evts)
    launches = sum(e.count for e in avg if e.key in _LAUNCH_CALLS)
    kernels = sum(e.count for e in dev_evts)
    ops = sum(e.count for e in avg if e.key.startswith("aten::"))
    top_host = sorted((e for e in avg if e.key.startswith("aten::")),
                      key=lambda e: -e.self_cpu_time_total)[:12]
    top_dev = sorted(dev_evts, key=lambda e: -_dev_us(e))[:12]
    dmc_kernels = {name: {
        "launches_per_step": sum(e.count for e in dev_evts if name in e.key)
        / steps,
        "device_ms_per_step": sum(_dev_us(e) for e in dev_evts
                                  if name in e.key) / steps / 1e3}
        for name in DMC_KERNELS}
    wall_ms = wall / steps * 1e3
    busy_ms = busy_us / steps / 1e3
    return {
        "device": torch.cuda.get_device_name(0), "batch": batch,
        "gates": gates, "widths": widths, "steps": steps,
        "step": "graph" if seg.graph else "eager",
        "warm_up_s": warm_s,
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "replay_ms": replay_ms, "part_ms": part_ms,
        "traced_wall_ms_per_step": traced / steps * 1e3,
        "kernel_launches_per_step": launches / steps,
        "device_kernels_per_step": kernels / steps,
        "aten_calls_per_step": ops / steps,
        "top_host_ops": [[e.key, e.count // steps,
                          e.self_cpu_time_total / steps / 1e3]
                         for e in top_host],
        "top_device_kernels": [[e.key[:80], e.count // steps,
                                _dev_us(e) / steps / 1e3] for e in top_dev],
        "dmc_kernels": dmc_kernels,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8,
                    help="steps per segment (a power of two)")
    ap.add_argument("--gates", choices=sorted(GATE_SETS), default="bench")
    ap.add_argument("--widths", choices=sorted(WIDTHS), default="bench")
    args = ap.parse_args(argv)
    for graph in (True, False):
        print(json.dumps(profile_steps(args.batch, args.steps, args.gates,
                                       graph, args.widths)), flush=True)


if __name__ == "__main__":
    main()
