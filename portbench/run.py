"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the program (``cmix_tpu_torch``).  Prints the compared numbers
beside their limits as the last lines of standard error, and one JSON
line as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  Exits 2 without a result when the
card or the cards the cell asks for are missing, 3 when the program
cannot be loaded, 1 when the run is not correct.
"""

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# every cache the program or torch may write stays in the checkout, at
# fixed paths (the program builds its kernels into build/cmix_tpu_torch)
CACHE = os.path.join(ROOT, "build", "portbench")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
# the switches the program reads from the environment for routed content:
# a cell codes what its configuration file says, whatever the machine sets
for var in ("CMIX_JPEGC", "JVAL_ROUTE", "WRTW_ROUTE"):
    os.environ.pop(var, None)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness.spec import Cell
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from portbench.harness import cell as runner
    try:
        program = runner.Program()
    except ImportError as e:
        print(f"portbench: the program cannot be loaded: {e}",
              file=sys.stderr)
        return 3
    result, lines = runner.run(cell, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0),
                               T_START, program=program)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
