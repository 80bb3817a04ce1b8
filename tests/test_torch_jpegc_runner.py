"""The routed fixture under CMIX_JPEGC=0 and PORT=1 across the two
packages on the CPU: the port's ``runner.compress`` writes the committed
``testdata/routed_nojpegc.tcmx`` byte for byte (its JPEG a pass-through
segment, so no JPEGX in the gate record), which is the JAX package's
archive (the golden ``routed_nojpegc``), and decodes it exactly.  (The
port once recoded the JPEG under the same switch and wrote its
CMIX_JPEGC=1 archive.)  The archives being equal, that is the
cross-decode: ``RUN_SLOW=1 pytest tests/test_torch_goldens.py`` re-encodes
the input with the JAX package and decodes the archive there.  Rewrite
the golden after a deliberate format change with ``JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/torch_parity.py --write-goldens
routed_nojpegc``."""

import struct

import chip_smoke
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from torch_parity import jax_golden


def _record(arc):
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    return arc[off + 2:off + 2 + glen]


def test_both_packages_write_and_decode_the_nojpegc_archive(monkeypatch):
    with open(chip_smoke.ROUTED_FIXTURE, "rb") as f:
        data = f.read()
    with open(chip_smoke.ROUTED_NOJPEGC_ARCHIVE, "rb") as f:
        ref = f.read()
    assert len(ref) == 3195 and _record(ref) == b"X86X=2;GRID2=1;PORT=1"
    a_jax = jax_golden("routed_nojpegc", data, config=chip_smoke.ROUTED_SMALL,
                       gates={"PORT": 1}, env={"CMIX_JPEGC": "0"},
                       max_batch=chip_smoke.ROUTED_BATCH)
    monkeypatch.setenv("CMIX_JPEGC", "0")
    a_port = runner.compress(
        data, E.EngineConfig(**chip_smoke.ROUTED_SMALL),
        max_batch=chip_smoke.ROUTED_BATCH, gates={"PORT": 1}, device="cpu")
    assert a_jax == ref
    assert a_port == ref
    # the segment table says it: the JPEG's 1078 B kept as they are
    seg_meta, _ = runner._read_seg_table(a_port, 4 + runner._HDR_LEN + 2
                                         + len(_record(a_port)))
    assert seg_meta[-1] == (6, 1078, 1078)
    # decode follows the archive, whatever the environment says
    monkeypatch.setenv("CMIX_JPEGC", "1")
    assert runner.decompress(a_jax, device="cpu") == data
