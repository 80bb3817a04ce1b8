"""One run of one cell: set-up, the measured window of jobs, the check.

The window is a closed loop of jobs, one at a time.  A job makes one
input (``traffic.Jobs``) and codes it through the program's library
calls, the CLI's ``c`` and ``d``: ``cmix_tpu_torch.runner.compress`` and
then ``decompress`` of that archive, each with its own
``utils.profiling.Meter``.  Jobs run until ``seconds`` have passed and at
least the traffic's ``fixed_jobs`` are done; the job in flight finishes
and counts.  Each call builds its own transcoder and captures its own
graph, as every file a user codes does.

Set-up loads the program (building its CUDA kernel on a checkout's first
run), then warms the process with one short call each way at the cell's
lanes and widths (blocks of ``WARM_BYTES``), so the window compiles
nothing.

With ``trace`` one more encode call, of the next job, follows the
window and is traced over ``TRACE_REPLAYS`` graph replays after a lead
replay ``TRACE_FIRST`` (``trace.ReplayTrace``), so that the tracer slows
none of the window's calls; the per-layer metrics' readers get the
window's call records and the trace's summary.

After the window: the peak device memory is read, the program's state is
freed, and the reference (a frozen copy of the program with a plain DMC,
``reference/__init__.py``) writes the archive of one job drawn from the
seed (``check.py``).
"""

import gc
import json
import subprocess
import sys
import time

from portbench.harness import check, counts
from portbench.harness import trace as tr
from portbench.harness.spec import engine_kwargs
from portbench.harness.traffic import Jobs, _rng

WARM_BYTES = 16
TRACE_FIRST, TRACE_REPLAYS = 64, 8
FORBIDDEN = ("jax", "jaxlib", "flax", "cmix_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (``cmix_tpu_torch`` is not ``cmix_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card(device):
    """(name, power limit) of the card, the limit from nvidia-smi."""
    import torch
    if device.type != "cuda":
        return "cpu", "none"
    name = torch.cuda.get_device_name(device)
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        limit = res.stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return name, limit


def call_record(seconds, meter, seg_size, n_in, n_out):
    return {"seconds": seconds, "meter_s": sum(meter.t.values()),
            "phases": dict(meter.t), "steps": meter.segments * seg_size,
            "in_bytes": n_in, "out_bytes": n_out}


def _warm(program, cell, jobs, device):
    """One short compress and decompress at the cell's lanes and widths:
    the first WARM_BYTES of every piece of job 0, in blocks of that size
    -> [(seconds, capture seconds)] of the two calls, for the log."""
    cfg = cell.config
    ecfg = program.EngineConfig(**dict(engine_kwargs(cfg),
                                       block_size=WARM_BYTES,
                                       seg_size=WARM_BYTES))
    piece = jobs.piece
    data = b"".join(jobs.job(0)[i:i + WARM_BYTES]
                    for i in range(0, jobs.lanes * piece, piece))
    out, m, t = [], program.Meter(), time.perf_counter()
    arc = program.compress(data, ecfg, max_batch=int(cfg["max_batch"]),
                           gates=dict(cfg["gates"]), device=device, meter=m)
    out.append((time.perf_counter() - t, m.t.get("compile", 0.0)))
    m, t = program.Meter(), time.perf_counter()
    program.decompress(arc, device=device, meter=m)
    out.append((time.perf_counter() - t, m.t.get("compile", 0.0)))
    return out


def _job(program, data, ecfg, max_batch, gates, device, dec):
    """compress ``data``, and with a ``dec`` list decompress the archive
    (its record appended there) -> (the encode's record, archive, bytes
    back or None)."""
    m = program.Meter()
    t = time.perf_counter()
    arc = program.compress(data, ecfg, max_batch=max_batch, gates=gates,
                           device=device, meter=m)
    rec = call_record(time.perf_counter() - t, m, ecfg.seg_size, len(data),
                      len(arc))
    if dec is None:
        return rec, arc, None
    m = program.Meter()
    t = time.perf_counter()
    back = program.decompress(arc, device=device, meter=m)
    dec.append(call_record(time.perf_counter() - t, m, ecfg.seg_size,
                           len(arc), len(back)))
    return rec, arc, back


class Program:
    """The program's entry points (cmix_tpu_torch), loaded by name."""

    def __init__(self):
        from cmix_tpu_torch import runner
        from cmix_tpu_torch.engine import EngineConfig
        from cmix_tpu_torch.utils.profiling import Meter
        self.compress, self.decompress = runner.compress, runner.decompress
        self.EngineConfig, self.Meter = EngineConfig, Meter


def run(cell, seed, seconds, trace, device, t_start, program=None):
    """Set-up, window and check of ``cell`` -> (result dict, stderr
    lines of the compared numbers); ``program`` the loaded ``Program``."""
    import torch
    if program is None:
        program = Program()
    jobs = Jobs(cell.traffic, seed, cell.bench_dir)
    cfg = cell.config
    ecfg = program.EngineConfig(**engine_kwargs(cfg))
    gates = dict(cfg["gates"])
    max_batch = int(cfg["max_batch"])
    t_in = time.perf_counter()
    name, limit = card(device)
    t_card = time.perf_counter()
    torch.zeros(1, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_ctx = time.perf_counter()
    warm = _warm(program, cell, jobs, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"card: {name}, power limit {limit}; set-up {setup_s:.3f} s")
    log("set-up phases [s]: " + json.dumps({
        "imports_and_program": round(t_in - t_start, 4),
        "card_query": round(t_card - t_in, 4),
        "device_context": round(t_ctx - t_card, 4),
        "warm_encode": [round(x, 4) for x in warm[0]],
        "warm_decode": [round(x, 4) for x in warm[1]]}))

    # ---- the window
    enc, dec, archives, sizes = [], [], [], []
    traced_call, summary = None, None
    bad_rt = failed = 0
    t0 = time.perf_counter()
    j = 0
    while True:
        data = jobs.job(j)
        try:
            rec, arc, back = _job(program, data, ecfg, max_batch, gates,
                                  device, dec)
        except Exception as e:          # the program failed: no result
            log(f"job {j}: {type(e).__name__}: {e}")
            failed += 1
            break
        enc.append(rec)
        archives.append(arc)
        sizes.append(len(data))
        bad_rt += check.diff_bytes(back, data)
        j += 1
        if time.perf_counter() - t0 >= seconds and j >= jobs.fixed:
            break
    window_s = time.perf_counter() - t0
    if trace and not failed:
        # the traced call: one more encode, after the window, so that the
        # tracer slows none of the window's calls
        rt = tr.ReplayTrace(TRACE_FIRST, TRACE_REPLAYS)
        with rt:
            traced_call = _job(program, jobs.job(j), ecfg, max_batch, gates,
                               device, None)[0]
        if rt.traced:
            summary = tr.summarize(tr.measured(rt.device, rt.cut_ns),
                                   rt.host,
                                   traced_call["steps"] * rt.traced
                                   / max(rt.replays, 1))
            if summary is not None:
                log(f"trace: {rt.traced} replays after a lead replay, "
                    f"device span {summary['window_s']:.6f} s, busy "
                    f"{summary['busy_s']:.6f} s, host window "
                    f"{rt.host_window_s:.6f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    hdr = check.header(archives[0]) if archives else {}
    lanes = hdr.get("lanes", 0)
    log(f"window {window_s:.3f} s: {j} jobs, each {hdr.get('blocks')} "
        f"blocks of {hdr.get('block_size')} B in groups of {lanes} lanes; "
        f"{failed} failed")

    # ---- the check: the reference writes one job's archive, once the
    # program's state is freed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = {"roundtrip_bad_bytes": bad_rt, "archive_bad_bytes": 0}
    if archives:
        k = int(_rng(seed, 2).integers(len(archives)))
        from portbench.reference import runner as reference
        from portbench.reference.engine import EngineConfig as RC
        t = time.perf_counter()
        ref = reference.compress(
            jobs.job(k), RC(**engine_kwargs(cfg)), max_batch=max_batch,
            gates=gates, device=device)
        values["archive_bad_bytes"] = check.diff_bytes(archives[k], ref)
        sha = [check.streams_sha256(check.archive_streams(a))[:16]
               for a in (archives[k], ref)]
        log(f"reference: job {k} in {time.perf_counter() - t:.3f} s; "
            f"archive {len(archives[k])} B, reference {len(ref)} B; "
            f"streams sha256 {sha[0]} / {sha[1]}; "
            f"first difference: {check.first_diff(archives[k], ref)}")
    ok, rows = check.verdict(values)
    correct = ok and failed == 0 and bool(archives)

    # ---- the metrics
    fixed = min(jobs.fixed, len(archives))
    e2e = {
        "encode_mib_s": (sum(r["in_bytes"] for r in enc) / 2**20
                         / max(sum(r["seconds"] for r in enc), 1e-12)),
        "decode_mib_s": (sum(r["out_bytes"] for r in dec) / 2**20
                         / max(sum(r["seconds"] for r in dec), 1e-12)),
        "bpb": (8.0 * sum(len(a) for a in archives[:fixed])
                / max(sum(sizes[:fixed]), 1)),
        "setup_s": setup_s,
    }
    result = {"correct": correct, "attempted": j + failed, "failed": failed}
    if trace:
        ctx = {"enc": enc, "dec": dec, "traced": traced_call,
               "trace": summary, "config": cfg, "lanes": lanes,
               "sizes": counts.ensemble_sizes(gates),
               "levels": _dmc_levels(gates)}
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if device.type == "cuda" else "cpu",
                        "kind": name, "count": cell.chips,
                        "memory_peak_bytes": peak, "power_limit": limit}
    if trace and summary is not None:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for label, calls in (("encode", enc), ("decode", dec)):
        log(f"{label} calls [s, capture s, device s, host s]: " + json.dumps(
            [[round(c["seconds"], 4)] + [round(c["phases"].get(k, 0.0), 4)
                                         for k in ("compile", "device",
                                                   "host")]
             for c in calls]))
    lines = [f"check {k}: {v} (limit {lim})" for k, v, lim in rows]
    return result, lines


def _dmc_levels(gates):
    from portbench.reference.engine import make_gates
    return make_gates(gates).dmc_levels
