"""Where a byte step's time goes on the GPU (torch.profiler).

    python -m cmix_tpu_torch.utils.profiling [--batch 256] [--steps 8]
        [--gates bench|bench-x86|default|routed|portable|wrtw]

Builds the byte step of the bench speed profile (bench widths, the blocks
of ``testdata/bench4m.raw``), or of another gate set at the same widths:
the bench set with X86X=2 (what the runner routes for bench4m.raw, whose
detector finds x86 code), the default gates, the default gates with the
media and JPEG routes (GRID2=1, LMS=2, JPEGX=1; every block marked as
24-bit image, so the LMS votes), the portable profile (PORT=1 on the
default gates), or the default gates with WRTW=1 (what the runner routes
for a dictionary-coded archive: the WRT codeword tracker); warms it up, then traces ``--steps`` steps with CPU and
CUDA activities and
prints one JSON line: wall ms per step (host clock, synchronised), device
busy ms per step (the sum of kernel and copy times on the one stream) and
the idle share, kernel launches and operator calls per step, the top
operators by host time and the top kernels by device time, and always
the two DMC kernels' launches and device ms per step (``dmc_kernels``,
zero where the step launched none).  Needs a CUDA
device; the numbers are the card's, printed beside its name.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from cmix_tpu_torch import engine as E

# the device functions of csrc/dmc_fused.cu and csrc/dmc_counts.cu, found
# by name among the profiler's events
DMC_KERNELS = ("dmc_fused_kernel", "dmc_counts_kernel")
GATE_SETS = {"bench": E.BENCH_GATES,
             "bench-x86": dict(E.BENCH_GATES, X86X=2),
             "default": {},
             "routed": {"GRID2": 1, "LMS": 2, "JPEGX": 1},
             "portable": {"PORT": 1},
             "wrtw": {"WRTW": 1}}
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _dev_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def profile_steps(batch=256, warm=4, steps=8, gates="bench"):
    dev = E.resolve_device("cuda")
    g = E.make_gates(GATE_SETS[gates])
    cfg = E.EngineConfig(block_size=16384, tbits=18, mbits=18, ibits=16,
                         lstm_hidden=256, seg_size=2048, dmc_nodes=16384,
                         lstm_horizon=4)
    raw = np.fromfile(os.path.join(_ROOT, "testdata", "bench4m.raw"),
                      dtype=np.uint8)
    lanes = raw[:batch * (len(raw) // batch)].reshape(batch, -1)
    inp = torch.as_tensor(lanes[:, :warm + steps].T.copy(), device=dev)
    sh = E.init_shared(cfg, g, dev)
    pb = E.init_perblock(cfg, g, batch, dev)
    if g.lms:
        pb["blk_kind"].fill_(3)
    cd = E.init_coder(batch, dev)
    comp = torch.zeros((batch, cfg.comp_size), dtype=torch.uint8, device=dev)
    mode = torch.zeros(batch, dtype=torch.int64, device=dev)
    step = E.make_byte_step(cfg, g, dev)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        for t in range(warm):
            sh, pb, cd, _, _ = step(sh, pb, cd, comp, inp[t], t, mode)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.time()
            for t in range(warm, warm + steps):
                sh, pb, cd, _, _ = step(sh, pb, cd, comp, inp[t], t, mode)
            torch.cuda.synchronize()
            wall = time.time() - t0
    avg = prof.key_averages()
    busy_us = sum(_dev_us(e) for e in avg)
    launches = sum(e.count for e in avg if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    ops = sum(e.count for e in avg if e.key.startswith("aten::"))
    top_host = sorted((e for e in avg if e.key.startswith("aten::")),
                      key=lambda e: -e.self_cpu_time_total)[:12]
    top_dev = sorted((e for e in avg if _dev_us(e) > 0),
                     key=lambda e: -_dev_us(e))[:12]
    dmc_kernels = {name: {
        "launches_per_step": sum(e.count for e in avg if name in e.key)
        / steps,
        "device_ms_per_step": sum(_dev_us(e) for e in avg if name in e.key)
        / steps / 1e3} for name in DMC_KERNELS}
    wall_ms = wall / steps * 1e3
    busy_ms = busy_us / steps / 1e3
    return {
        "device": torch.cuda.get_device_name(0), "batch": batch,
        "gates": gates, "steps": steps,
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": launches / steps,
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
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--gates", choices=sorted(GATE_SETS), default="bench")
    args = ap.parse_args(argv)
    print(json.dumps(profile_steps(args.batch, args.warm, args.steps,
                                   args.gates)))


if __name__ == "__main__":
    main()
