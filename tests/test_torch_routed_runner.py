"""The routed fixture under PORT=1 across the two packages on the CPU: the
port writes the JAX package's archive byte for byte (the committed
``testdata/routed.tcmx``, which tests/test_torch_routed_fixture.py holds to
the JAX package's encode and decode) and decodes it exactly."""

import struct

from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from golden_cases import read_case


def test_port_writes_the_jax_archive_of_the_routed_fixture():
    e, data, _, ref = read_case("routed")
    arc = runner.compress(data, E.EngineConfig(**e["config"]),
                          max_batch=e["max_batch"], gates=e["gates"],
                          device="cpu")
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    assert arc[off + 2:off + 2 + glen] == b"X86X=2;GRID2=1;JPEGX=1;PORT=1"
    assert arc == ref


def test_port_decodes_the_jax_archive_of_the_routed_fixture():
    _, data, _, ref = read_case("routed")
    assert runner.decompress(ref, device="cpu") == data
