"""Both packages' CLIs take the model gates from the environment: under the
bench gate set, encoded in subprocesses, the port's archive carries the
JAX package's gate record, and each archive decodes in a clean
environment.  (The port's CLI once ignored the environment and wrote a
default-gate archive under the same command.)
test_torch_env_gates_sse2.py runs the same under SSE2=1."""

import os
import struct
import subprocess
import sys

from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--block-size", "64", "--tbits", "10", "--lstm", "8", "--dmc",
         "4096", "--max-batch", "4"]


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k not in E.GATE_NAMES
           and k not in ("JVAL_ROUTE", "WRTW_ROUTE")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


def _run_both(jobs):
    """Run the (args, env) jobs side by side; each must exit 0."""
    procs = [subprocess.Popen([sys.executable, "-m"] + args, env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args, env in jobs]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]


def _record(path):
    arc = path.read_bytes()
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    return arc[off + 2:off + 2 + glen]


def check_env_gates(tmp_path, gates):
    """Encode with ``gates`` in the environment through both CLIs, then
    decode each archive with its own package in a clean environment."""
    src = tmp_path / "in.txt"
    with open(os.path.join(ROOT, "testdata", "text100k.raw"), "rb") as f:
        src.write_bytes(f.read()[:256])
    enc = dict(_clean_env(), **{k: str(v) for k, v in gates.items()})
    j, t = tmp_path / "j.tcmx", tmp_path / "t.tcmx"
    _run_both([(["cmix_tpu.runner", "c", str(src), str(j)] + FLAGS, enc),
               (["cmix_tpu_torch.runner", "c", str(src), str(t)] + FLAGS
                + ["--device", "cpu"], enc)])
    want = E.make_gates(gates).blob()
    assert want and _record(j) == want and _record(t) == want
    jb, tb = tmp_path / "j.out", tmp_path / "t.out"
    clean = _clean_env()
    _run_both([(["cmix_tpu.runner", "d", str(j), str(jb)], clean),
               (["cmix_tpu_torch.runner", "d", str(t), str(tb), "--device",
                 "cpu"], clean)])
    assert jb.read_bytes() == src.read_bytes() == tb.read_bytes()


def test_bench_gates_from_the_environment(tmp_path):
    check_env_gates(tmp_path, E.BENCH_GATES)
