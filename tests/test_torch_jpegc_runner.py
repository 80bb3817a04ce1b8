"""The routed fixture under CMIX_JPEGC=0 and PORT=1 across the two
packages on the CPU: both ``runner.compress`` write the committed
``testdata/routed_nojpegc.tcmx`` byte for byte (its JPEG a pass-through
segment, so no JPEGX in the gate record), and each package decodes the
other's archive exactly.  (The port once recoded the JPEG under the same
switch and wrote its CMIX_JPEGC=1 archive.)  Rewrite the fixture after a
deliberate format change with ``PYTHONPATH=. python tests/torch_parity.py
--write-routed-nojpegc-fixture``."""

import struct

import chip_smoke
from cmix_tpu import engine as je
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from torch_parity import jax_runner_gates


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
    monkeypatch.setenv("CMIX_JPEGC", "0")
    with jax_runner_gates({"PORT": 1}) as jr:
        a_jax = jr.compress(data, je.EngineConfig(**chip_smoke.ROUTED_SMALL),
                            max_batch=chip_smoke.ROUTED_BATCH)
        a_port = runner.compress(
            data, E.EngineConfig(**chip_smoke.ROUTED_SMALL),
            max_batch=chip_smoke.ROUTED_BATCH, gates={"PORT": 1},
            device="cpu")
        assert a_jax == ref
        assert a_port == ref
        assert jr.decompress(a_port) == data
    # the segment table says it: the JPEG's 1078 B kept as they are
    seg_meta, _ = runner._read_seg_table(a_port, 4 + runner._HDR_LEN + 2
                                         + len(_record(a_port)))
    assert seg_meta[-1] == (6, 1078, 1078)
    # decode follows the archive, whatever the environment says
    monkeypatch.setenv("CMIX_JPEGC", "1")
    assert runner.decompress(a_jax, device="cpu") == data
