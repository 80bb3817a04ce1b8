"""The port's Python API takes the model gates from the environment, as
``cmix_tpu.runner.compress`` does: ``runner.compress`` given no ``gates``
codes with the gates set in ``os.environ`` (PORT=1 there writes the JAX
package's PORT=1 archive ``testdata/portable.tcmx`` byte for byte), while
a mapping the caller gives, ``{}`` included, is used as it is.  (The port's
``compress`` once ignored the environment and wrote a default-gate
archive.)  Port only: no JAX compile."""

import struct

import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from golden_cases import read_case
from torch_parity import RUNNER_KW


@pytest.fixture
def clean_env(monkeypatch):
    """No gate name in the environment; the test sets its own."""
    for name in E.GATE_NAMES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _record(arc):
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    return arc[off + 2:off + 2 + glen]


def _text():
    with open("testdata/text100k.raw", "rb") as f:
        return f.read()[2000:2128]


def _small(data, **kw):
    return runner.compress(data, E.EngineConfig(**RUNNER_KW), max_batch=2,
                           device="cpu", **kw)


def test_port_from_the_environment_writes_the_jax_archive(clean_env):
    e, data, _, ref = read_case("portable")
    assert e["gates"] == {"PORT": 1}
    clean_env.setenv("PORT", "1")
    arc = runner.compress(data, E.EngineConfig(**e["config"]),
                          max_batch=e["max_batch"], device="cpu")
    assert _record(arc) == b"PORT=1"
    assert arc == ref


def test_given_gates_are_used_as_given(clean_env):
    data = _text()
    default = _small(data)                      # nothing in the environment
    assert _record(default) == b""
    clean_env.setenv("PORT", "1")
    assert _small(data, gates={}) == default
    assert _record(_small(data, gates={"SSE2": 1})) == b"SSE2=1"


def test_a_mechanism_from_the_environment(clean_env):
    data = _text()
    clean_env.setenv("SSE2", "1")
    arc = _small(data)
    assert _record(arc) == E.make_gates({"SSE2": 1}).blob() == b"SSE2=1"
    assert arc == _small(data, gates={"SSE2": 1})
    # decode reads the archive's record, whatever the environment says
    clean_env.delenv("SSE2")
    clean_env.setenv("PORT", "1")
    assert runner.decompress(arc, device="cpu") == data
