"""The runner under ``utils/profiling.LEAN`` on the CPU: a small-width round
trip in the fast profile, and under PORT=1 the port's archive byte-identical
to the JAX package's, each package decoding the other's.
test_torch_gates_runner_knobs.py does the same for ``KNOBS``."""

import pytest

from cmix_tpu import engine as je
from cmix_tpu_torch import engine as te
from cmix_tpu_torch import runner as tr
from cmix_tpu_torch.utils.profiling import LEAN
from torch_parity import RUNNER_KW, jax_runner_gates

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


def check_port_cross_decode(env):
    data = _text()
    env = dict(env, PORT=1)
    at = tr.compress(data, te.EngineConfig(**KW), max_batch=BATCH, gates=env,
                     device="cpu")
    with jax_runner_gates(env) as jr:
        aj = jr.compress(data, je.EngineConfig(**KW), max_batch=BATCH)
        assert at == aj
        assert jr.decompress(at) == data
    assert tr.decompress(aj, device="cpu") == data


@pytest.mark.parametrize("leg", ["fast", "port"])
def test_lean_runner(leg):
    (check_fast_round_trip if leg == "fast" else check_port_cross_decode)(
        LEAN)
