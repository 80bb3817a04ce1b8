"""The traced part of a run, and what is read from it.

``ReplayTrace`` traces a bounded part of one coding call: the program
replays its captured byte step once a step (``torch.cuda.CUDAGraph.replay``).
The profiler starts at replay ``first``, which is a lead replay: it takes
the tracer's own first-launch cost and is waited for, and a host marker
(``CUT``) is recorded after it.  The ``count`` replays after it are the
measured part, and the trace stops once they have run.  Device operations
that start after the marker are the measured replays'.  It counts every
replay of the call, so the steps one replay codes are known whatever the
program puts in a graph.  A call that replays no graph (an eager step)
leaves the trace empty, and the metrics read from it are left out.

``summarize`` is the arithmetic of the port's
``utils/profiling.profile_steps``, copied: device busy time, the idle
share 1 - busy / wall, device operations (kernels, copies and fills) per
step and the top operations by device time; busy is the union of the
device operations' intervals.  Busy and wall come from the same measured
operations: the wall is the device's span from the first one's start to
the last one's end, so the share lies in [0, 1] whatever pace a call
runs at.  Beside it, the longest idle gaps on the device with the host
activity under each.
"""

import time

import torch

TOP = 10
CUT = "portbench.measured_replays"


def _ns(evt, what):
    f = getattr(evt, what + "_ns", None)
    if f is not None:
        return f()
    return getattr(evt, what + "_us")() * 1000


def _is_device(evt):
    return str(evt.device_type()).endswith("CUDA")


class ReplayTrace:
    """Context manager: trace the lead replay ``first`` and the ``count``
    replays after it, of the graph replays made inside it.  After exit:
    ``device`` and ``host`` lists of (name, start_ns, end_ns), ``cut_ns``
    (the host marker after the lead replay, or None), ``host_window_s``
    (host clock, from the profiler's start to the last synchronisation),
    ``traced`` (measured replays) and ``replays`` (all replays made)."""

    def __init__(self, first, count):
        self.first, self.count = first, count
        self.device, self.host = [], []
        self.cut_ns = None
        self.host_window_s = 0.0
        self.traced = self.replays = 0
        self._prof = None

    def __enter__(self):
        graph_cls = torch.cuda.CUDAGraph
        self._orig = orig = graph_cls.replay
        tr = self

        def replay(graph):
            i = tr.replays
            tr.replays += 1
            if i == tr.first:
                tr._start()
            orig(graph)
            if tr._prof is None:
                return
            if i == tr.first:
                # the lead replay is done before the marker: the
                # operations after it are the measured replays'
                torch.cuda.synchronize()
                with torch.profiler.record_function(CUT):
                    pass
                return
            tr.traced += 1
            if tr.traced == tr.count:
                tr._stop()

        graph_cls.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._orig
        if self._prof is not None:
            self._stop()
        return False

    def _start(self):
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=act)
        self._prof.start()
        self._t0 = time.perf_counter()

    def _stop(self):
        torch.cuda.synchronize()
        self.host_window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.stop()
        for evt in prof.profiler.kineto_results.events():
            rec = (evt.name(), _ns(evt, "start"), _ns(evt, "end"))
            (self.device if _is_device(evt) else self.host).append(rec)
        cuts = [s for name, s, _ in self.host if name == CUT]
        self.cut_ns = min(cuts) if cuts else None


def _union_ns(events):
    total, end = 0, None
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _host_at(host, t):
    """The innermost host activity covering time ``t`` (ns)."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "host idle"


def idle_gaps(device, host, top=TOP):
    """The ``top`` longest gaps between device operations: [[name,
    seconds]], each named by the host activity under its middle and the
    operation that ends it."""
    gaps, end, prev = [], None, None
    for name, s, e in sorted(device, key=lambda x: x[1]):
        if end is not None and s > end:
            gaps.append((s - end, end, s, name))
        if end is None or e > end:
            end = e
    gaps.sort(key=lambda g: -g[0])
    return [[f"{_host_at(host, (a + b) // 2)[:60]} | before "
             f"{name[:60]}", d / 1e9] for d, a, b, name in gaps[:top]]


def measured(device, cut_ns):
    """The device operations that start after ``cut_ns`` (all of them
    where it is None)."""
    if cut_ns is None:
        return list(device)
    return [d for d in device if d[1] >= cut_ns]


def summarize(device, host, steps, top=TOP):
    """profile_steps' arithmetic over the device operations ``device`` of
    a traced part of ``steps`` byte steps -> dict: busy_s, window_s (the
    device's span over them), idle_share, ops_per_step, device_s by
    operation name, device_ops and idle_gaps (the breakdown's lists);
    None where ``device`` is empty."""
    if not device:
        return None
    busy_s = _union_ns(device) / 1e9
    window_s = (max(e for _, _, e in device)
                - min(s for _, s, _ in device)) / 1e9
    by_name = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": window_s,
            "idle_share": 1.0 - busy_s / window_s if window_s else None,
            "ops_per_step": len(device) / steps if steps else None,
            "device_s": by_name, "steps": steps,
            "device_ops": [[n[:96], s] for n, s in ops[:top]],
            "idle_gaps": idle_gaps(device, host, top)}
