"""The portable profile's archives across the two packages on the CPU:
``cmix_tpu_torch`` writes the JAX package's PORT=1 archive of the same
input and config (the golden ``port_runner``) byte for byte and decodes
it exactly; the archives being equal, ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` has the JAX package decode it, which is the
other direction.  And ``--portable`` on the port's CLI."""

import struct

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from torch_parity import RUNNER_KW, jax_golden


def test_port_archives_cross_decode_both_ways():
    # five 64-byte blocks at exec batch 3: a group of three lanes, then a
    # group of two padded with a dummy lane
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[3000:3300]
    a_jax = jax_golden("port_runner", data, config=RUNNER_KW,
                       gates={"PORT": 1}, max_batch=3)
    a_port = runner.compress(data, E.EngineConfig(**RUNNER_KW), max_batch=3,
                             gates={"PORT": 1}, device="cpu")
    assert a_port == a_jax
    assert runner.decompress(a_jax, device="cpu") == data
    # the record says what it is: PORT=1, exec batch 3, five coded blocks
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", a_port[off:off + 2])[0]
    assert a_port[off + 2:off + 2 + glen] == b"PORT=1"
    assert struct.unpack(runner._HDR, a_port[4:off])[12] == 3
    lens = struct.unpack("<5I", a_port[off + 2 + glen:off + 22 + glen])
    assert [L >> 31 for L in lens] == [0] * 5


def test_portable_cli_roundtrip_on_cpu(tmp_path, capsys):
    src, arc, back = tmp_path / "in.txt", tmp_path / "a.tcmx", tmp_path / "b"
    with open("testdata/text100k.raw", "rb") as f:
        src.write_bytes(f.read()[6000:6096])
    small = ["--device", "cpu", "--block-size", "32", "--tbits", "10",
             "--lstm", "16", "--dmc", "4096"]
    runner.main(["t", str(src), str(arc), "--portable"] + small)
    assert "cross entropy" in capsys.readouterr().out
    runner.main(["d", str(arc), str(back), "--device", "cpu"])
    assert back.read_bytes() == src.read_bytes()
    a = arc.read_bytes()
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", a[off:off + 2])[0]
    assert a[off + 2:off + 2 + glen] == b"PORT=1"
