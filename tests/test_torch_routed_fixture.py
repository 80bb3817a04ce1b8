"""The committed routed fixture that chip_smoke.py holds the card to
(``testdata/routed.raw``: x86 code, a 24-bit BMP, a WAV and a baseline JPEG;
``testdata/routed.tcmx``: the JAX package's PORT=1 archive of it, the
golden ``routed``) cannot go stale: the archive is the golden of that input
at chip_smoke's config, its segment table is the JAX package's transform
of the input, and the input is still what ``make_routed_input`` makes
(with PIL).  ``RUN_SLOW=1 pytest tests/test_torch_goldens.py`` re-encodes
the input with the JAX package on the CPU and decodes the archive there.
tests/test_torch_routed_runner.py holds the port's encode to the same
bytes, so each package decodes the other's archive.

To rewrite the archive after a deliberate format change:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
--write-goldens routed``."""

import struct

import chip_smoke
from cmix_tpu.preprocess import wrt as jwrt
from cmix_tpu_torch import runner
from cmix_tpu_torch.preprocess import wrt
from torch_parity import jax_golden, make_routed_input


def test_routed_fixture_archive_is_the_jax_packages_encode():
    with open(chip_smoke.ROUTED_FIXTURE, "rb") as f:
        data = f.read()
    assert len(data) <= 12 << 10
    assert data == make_routed_input()
    arc = jax_golden("routed", data, config=chip_smoke.ROUTED_SMALL,
                     gates={"PORT": 1}, max_batch=chip_smoke.ROUTED_BATCH)
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
