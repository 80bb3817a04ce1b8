"""What a run measures, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and each metric; the files behind the names sit in
``portbench/``:

* ``configs/<config>.json``: the engine's sizes (``ENGINE_KEYS``), the
  lanes a coding group takes (``max_batch``) and the model gates, as run;
* ``traffic/<traffic>.json``: the generator's parameters (``traffic.py``);
* ``metrics/<name>.py``: one reader a per-layer metric, ``read(ctx)`` ->
  a number, or None where the run gave it nothing to read.

A cell, a configuration, a traffic mix or a metric is added as new files
and entries; no file here changes.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
ENGINE_KEYS = ("block_size", "tbits", "mbits", "ibits", "pbits",
               "lstm_hidden", "lstm_layers", "lstm_horizon", "dmc_nodes",
               "seg_size")


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_config(name, bench_dir=BENCH_DIR):
    """The configuration ``name`` as run: its file's engine sizes, gates and
    max_batch (the file's other keys document it)."""
    with open(os.path.join(bench_dir, "configs", name + ".json")) as f:
        spec = json.load(f)
    missing = [k for k in ENGINE_KEYS + ("max_batch", "gates")
               if k not in spec]
    if missing:
        raise ValueError(f"config {name}: missing {missing}")
    return spec


def engine_kwargs(config):
    return {k: int(config[k]) for k in ENGINE_KEYS}


def in_cell(metric, workload):
    """Whether ``metric`` is reported in the cell ``workload``."""
    return workload in metric.get("workloads", [workload])


class Cell:
    """One workload of the benchmark, with its configuration, traffic and
    metrics."""

    def __init__(self, name, bench=None, bench_dir=BENCH_DIR):
        bench = bench if bench is not None else load_benchmark()
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = found[0]
        self.chips = int(self.workload["chips"])
        self.config = load_config(self.workload["config"], bench_dir)
        from portbench.harness import traffic
        self.traffic = traffic.load(self.workload["traffic"], bench_dir)
        self.bench_dir = bench_dir
        self.end_to_end = [m for m in bench["end_to_end"]
                           if in_cell(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if in_cell(m, name)]

    def reader(self, metric_name):
        """The per-layer metric's ``read`` function (metrics/<name>.py)."""
        path = os.path.join(self.bench_dir, "metrics", metric_name + ".py")
        mod_name = "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric_name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
