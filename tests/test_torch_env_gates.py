"""Both packages' CLIs take the model gates from the environment: under the
bench gate set, the port's CLI encodes in a subprocess, its archive carries
the gate record of the JAX package's CLI archive under the same command
(the golden ``cli_env_bench``), and it decodes in a clean environment.
(The port's CLI once ignored the environment and wrote a default-gate
archive under the same command.)  ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` runs the JAX package's CLI both ways, its
decode in a clean environment.  test_torch_env_gates_sse2.py runs the
same under SSE2=1."""

import os
import struct

from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from torch_parity import ROOT, cli_env, jax_golden, run_cli

FLAGS = ["--block-size", "64", "--tbits", "10", "--lstm", "8", "--dmc",
         "4096", "--max-batch", "4"]


def _record(arc):
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    return arc[off + 2:off + 2 + glen]


def check_env_gates(tmp_path, gates, case):
    """Encode with ``gates`` in the environment through the port's CLI,
    against the JAX package's CLI archive (golden ``case``), then decode it
    in a clean environment."""
    src = tmp_path / "in.txt"
    with open(os.path.join(ROOT, "testdata", "text100k.raw"), "rb") as f:
        src.write_bytes(f.read()[:256])
    enc = {k: str(v) for k, v in gates.items()}
    j = jax_golden(case, src.read_bytes(), call="cli", args=FLAGS, env=enc)
    t = tmp_path / "t.tcmx"
    run_cli("cmix_tpu_torch", ["c", str(src), str(t)] + FLAGS
            + ["--device", "cpu"], cli_env(**enc))
    want = E.make_gates(gates).blob()
    assert want and _record(j) == want and _record(t.read_bytes()) == want
    tb = tmp_path / "t.out"
    run_cli("cmix_tpu_torch", ["d", str(t), str(tb), "--device", "cpu"],
            cli_env())
    assert tb.read_bytes() == src.read_bytes()


def test_bench_gates_from_the_environment(tmp_path):
    check_env_gates(tmp_path, E.BENCH_GATES, "cli_env_bench")
