"""The committed routed fixture that chip_smoke.py holds the card to
(``testdata/routed.raw``: x86 code, a 24-bit BMP, a WAV and a baseline JPEG;
``testdata/routed.tcmx``: the JAX package's PORT=1 archive of it) cannot go
stale: the JAX package re-encodes the input at chip_smoke's config on the
CPU to the same bytes, and decodes them.  tests/test_torch_routed_runner.py
holds the port's encode to the same bytes, so each package decodes the
other's archive.

To rewrite both files after a deliberate format change (needs PIL):
``PYTHONPATH=. python tests/torch_parity.py --write-routed-fixture``."""

import struct

import chip_smoke
from cmix_tpu.preprocess import wrt as jwrt
from cmix_tpu_torch import runner
from cmix_tpu_torch.preprocess import wrt
from torch_parity import jax_runner_gates, routed_fixture


def test_routed_fixture_archive_is_the_jax_packages_encode():
    data, arc = routed_fixture()
    assert len(data) <= 12 << 10
    with open(chip_smoke.ROUTED_ARCHIVE, "rb") as f:
        assert f.read() == arc
    # its segment table: x86 code, a 24-bit image, audio, a recoded JPEG
    assert arc[5] & runner._FLAG_WRT
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    meta, _ = runner._read_seg_table(arc, off + 2 + glen)
    assert {wrt.SEG_EXE, wrt.SEG_IMG24, wrt.SEG_AUDIO, wrt.SEG_JPEGC} <= {
        e[0] for e in meta}
    assert meta == [tuple(e) for e in jwrt.transform(data, None)[1]]
    with jax_runner_gates({"PORT": 1}) as jr:
        assert jr.decompress(arc) == data
