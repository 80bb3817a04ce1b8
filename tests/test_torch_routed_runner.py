"""The routed fixture under PORT=1 across the two packages on the CPU: the
port writes the JAX package's archive byte for byte (the committed
``testdata/routed.tcmx``, which tests/test_torch_routed_fixture.py holds to
the JAX package's encode and decode) and decodes it exactly."""

import struct

import chip_smoke
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner


def _fixture():
    with open(chip_smoke.ROUTED_FIXTURE, "rb") as f:
        data = f.read()
    with open(chip_smoke.ROUTED_ARCHIVE, "rb") as f:
        return data, f.read()


def test_port_writes_the_jax_archive_of_the_routed_fixture():
    data, ref = _fixture()
    arc = runner.compress(data, E.EngineConfig(**chip_smoke.ROUTED_SMALL),
                          max_batch=chip_smoke.ROUTED_BATCH,
                          gates={"PORT": 1}, device="cpu")
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    assert arc[off + 2:off + 2 + glen] == b"X86X=2;GRID2=1;JPEGX=1;PORT=1"
    assert arc == ref


def test_port_decodes_the_jax_archive_of_the_routed_fixture():
    data, ref = _fixture()
    assert runner.decompress(ref, device="cpu") == data
