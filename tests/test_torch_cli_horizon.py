"""The CLI's ``--horizon auto`` rule in both packages: 4 up to 256 KiB of
input, 8 above.  Each CLI's ``compress`` is stubbed, so nothing is coded
at the CLI's widths and nothing compiled: the stubs catch the
``EngineConfig`` that ``main`` builds.  The port then codes a few bytes at
tiny widths with that horizon: its header carries it, and the decode
that reads it back is exact."""

import dataclasses
import struct

import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu import runner as jr
from cmix_tpu_torch import runner

EDGE = 256 << 10


@pytest.mark.parametrize("size,horizon", [(EDGE, 4), (EDGE + 1, 8)])
def test_auto_horizon_is_the_jax_clis(size, horizon, tmp_path, monkeypatch):
    src = tmp_path / "in.raw"
    with open("testdata/bench4m.raw", "rb") as f:
        src.write_bytes(f.read(size))
    seen = {}

    def jax_stub(data, cfg, **kw):
        seen["jax"] = (len(data), cfg)
        return b""

    real = runner.compress

    def port_stub(data, cfg, **kw):
        seen["port"] = (len(data), cfg)
        return b""

    monkeypatch.setattr(jr, "compress", jax_stub)
    monkeypatch.setattr(runner, "compress", port_stub)
    jr.main(["c", str(src), str(tmp_path / "jax.tcmx")])
    runner.main(["c", str(src), str(tmp_path / "port.tcmx"), "--device",
                 "cpu"])
    (nj, cj), (nt, ct) = seen["jax"], seen["port"]
    assert nj == nt == size
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert ct.lstm_horizon == horizon
    tiny = dataclasses.replace(ct, block_size=16, seg_size=16, tbits=10,
                               mbits=10, ibits=8, pbits=10, lstm_hidden=8,
                               dmc_nodes=4096)
    data = src.read_bytes()[:48]
    arc = real(data, tiny, gates={}, device="cpu")
    fields = struct.unpack(runner._HDR, arc[4:4 + runner._HDR_LEN])
    assert fields[10] == horizon                 # the header's lstm_horizon
    assert runner.decompress(arc, device="cpu") == data
