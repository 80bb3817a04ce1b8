"""The runner under ``utils/profiling.LEAN`` on the CPU: a small-width round
trip in the fast profile, and under PORT=1 the port's archive byte-identical
to the JAX package's (the golden ``lean_runner``), which the port decodes;
the archives being equal, ``RUN_SLOW=1 pytest tests/test_torch_goldens.py``
has the JAX package decode it.  test_torch_gates_runner_knobs.py does the
same for ``KNOBS``."""

import pytest

from cmix_tpu_torch import engine as te
from cmix_tpu_torch import runner as tr
from cmix_tpu_torch.utils.profiling import LEAN
from torch_parity import RUNNER_KW, jax_golden

KW = dict(RUNNER_KW, block_size=32, seg_size=32)
BATCH = 16                      # the 10 blocks in one coding group


def _text():
    with open("testdata/text100k.raw", "rb") as f:
        return f.read()[2000:2320]


def check_fast_round_trip(env):
    data = _text()
    arc = tr.compress(data, te.EngineConfig(**KW), max_batch=BATCH, gates=env,
                      device="cpu")
    off = 4 + tr._HDR_LEN
    glen = int.from_bytes(arc[off:off + 2], "little")
    assert arc[off + 2:off + 2 + glen] == te.make_gates(env).blob()
    assert tr.decompress(arc, device="cpu") == data


def check_port_cross_decode(env, case):
    data = _text()
    env = dict(env, PORT=1)
    at = tr.compress(data, te.EngineConfig(**KW), max_batch=BATCH, gates=env,
                     device="cpu")
    aj = jax_golden(case, data, config=KW, gates=env, max_batch=BATCH)
    assert at == aj
    assert tr.decompress(aj, device="cpu") == data


@pytest.mark.parametrize("leg", ["fast", "port"])
def test_lean_runner(leg):
    if leg == "fast":
        check_fast_round_trip(LEAN)
    else:
        check_port_cross_decode(LEAN, "lean_runner")
