"""The portable profile with every off-by-default mechanism it allows
(``utils/profiling.GATED_PORT``) and JVAL=2 routed by JVAL_ROUTE, on a
recoded JPEG (the routed fixture's): the port's archive is byte-identical
to the JAX package's (the golden ``gated_port_jpeg``); the archives being
equal, ``RUN_SLOW=1 pytest tests/test_torch_goldens.py`` has the JAX
package decode it.  test_torch_gated_port_decode.py has the port decode
the JAX package's."""

import pytest

from cmix_tpu_torch import engine as te
from cmix_tpu_torch import runner as tr
from cmix_tpu_torch.utils.profiling import GATED_PORT
from torch_parity import jax_golden

KW = dict(block_size=16, seg_size=16, tbits=10, mbits=10, ibits=8, pbits=10,
          lstm_hidden=8, lstm_horizon=2, dmc_nodes=4096)
BATCH = 128
# the gates the runner routes for a recoded JPEG with JVAL_ROUTE=2: the JAX
# package's transcoder, compiled once at them, then serves both directions
ROUTED = {"JPEGX": 1, "GRID2": 1, "JVAL": 2}


def jpeg_input():
    with open("testdata/routed.raw", "rb") as f:
        data = f.read()
    return data[data.index(b"\xff\xd8\xff"):]


def jax_archive(data):
    return jax_golden("gated_port_jpeg", data, config=KW,
                      gates=dict(GATED_PORT, **ROUTED),
                      env={"JVAL_ROUTE": "2"}, max_batch=BATCH)


@pytest.fixture
def jval_route(monkeypatch):
    monkeypatch.setenv("JVAL_ROUTE", "2")


def test_port_archive_is_the_jax_packages_and_decodes_there(jval_route):
    data = jpeg_input()
    at = tr.compress(data, te.EngineConfig(**KW), max_batch=BATCH,
                     gates=GATED_PORT, device="cpu")
    off = 4 + tr._HDR_LEN
    assert at[off + 2:off + 2 + at[off]] == te.make_gates(
        dict(GATED_PORT, **ROUTED)).blob()
    assert at == jax_archive(data)
