"""The readings that the limits of ``correct`` are set from, on the chip.

    python3 portbench/control.py --workload NAME --seeds S1,S2,...
        [--control-seeds S1,...]

In one process, at the cell's own size, for each seed one job of the
seed's traffic (one of its first four, drawn from the seed): the program
writes the job's archive through the timed path (``runner.compress`` on
the card) and decodes it; the reference (a frozen copy of the program
with a plain DMC, ``reference/__init__.py``) writes it; and, for the
control seeds, the reference writes it one precision step below what the
configuration states (``reference/lower.py``).  One JSON line a seed:

* ``program``: the program's archive against the reference's
  (``archive_bad_bytes``, the lower reading) and its round trip
  (``roundtrip_bad_bytes``);
* ``control``: the control's archive against the reference's (the upper
  reading), where the seed is a control seed.

The benchmark's own runs do not run the control.
"""

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "portbench",
                                             "cuda")
for var in ("CMIX_JPEGC", "JVAL_ROUTE", "WRTW_ROUTE"):
    os.environ.pop(var, None)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seeds, control_seeds, device, program=None):
    """-> [dict] a seed: the job, the program's and the control's
    readings and the seconds each side took."""
    from portbench.harness import check
    from portbench.harness.cell import Program
    from portbench.harness.spec import engine_kwargs
    from portbench.harness.traffic import Jobs, _rng
    from portbench.reference import runner as R
    from portbench.reference.engine import EngineConfig as RC
    from portbench.reference.lower import lower_precision
    program = program or Program()
    cfg = cell.config
    kw = engine_kwargs(cfg)
    gates, mb = dict(cfg["gates"]), int(cfg["max_batch"])
    port = bool(int(gates.get("PORT", 0)))
    out = []
    for seed in seeds:
        jobs = Jobs(cell.traffic, seed, cell.bench_dir)
        k = int(_rng(seed, 2).integers(4))
        data = jobs.job(k)
        row = {"seed": seed, "job": k, "bytes": len(data)}
        t = time.perf_counter()
        arc = program.compress(data, program.EngineConfig(**kw),
                               max_batch=mb, gates=gates, device=device)
        back = program.decompress(arc, device=device)
        row["program_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ref = R.compress(data, RC(**kw), max_batch=mb, gates=gates,
                         device=device)
        row["reference_s"] = time.perf_counter() - t
        row["program"] = {"archive_bad_bytes": check.diff_bytes(arc, ref),
                          "roundtrip_bad_bytes": check.diff_bytes(back,
                                                                  data),
                          "archive_bytes": len(arc),
                          "first_difference": check.first_diff(arc, ref)}
        if seed in control_seeds:
            t = time.perf_counter()
            with lower_precision(port):
                ctl = R.compress(data, RC(**kw), max_batch=mb, gates=gates,
                                 device=device)
            row["control_s"] = time.perf_counter() - t
            row["control"] = {"archive_bad_bytes": check.diff_bytes(ctl,
                                                                    ref),
                              "archive_bytes": len(ctl),
                              "first_difference": check.first_diff(ctl,
                                                                   ref)}
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench.harness.cell import card
    from portbench.harness.spec import Cell
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    print(json.dumps({"workload": cell.name, "card": card(dev)}),
          flush=True)
    rows = readings(cell, seeds, ctl, dev)
    lower = max(r["program"]["archive_bad_bytes"] for r in rows)
    upper = [r["control"]["archive_bad_bytes"] for r in rows
             if "control" in r]
    print(json.dumps({"workload": cell.name, "seeds": len(rows),
                      "lower_reading": lower,
                      "roundtrip_max": max(r["program"]["roundtrip_bad_bytes"]
                                           for r in rows),
                      "upper_reading": min(upper) if upper else None,
                      "seconds": time.perf_counter() - T_START}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
