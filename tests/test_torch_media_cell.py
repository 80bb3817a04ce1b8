"""The media deployment (a JPEG photo and a 16-bit WAV, one after the
other: ``portbench/corpus/jpeg-wav.raw``) on the CPU: its segment table and
per-block fields at 8,192-byte blocks against the JAX package's
preprocessing; the Meter's counters and the JPEG spans of a tiny routed
compress and decompress, whose archive a Meter leaves as it is; and where
the byte step marks its routed work (``engine.ROUTED``), which the card's
graph turns into event nodes only with GRID2, JPEGX or LMS on
(``tests/test_torch_cuda.py`` times them)."""

import numpy as np
import pytest
import torch

from cmix_tpu.preprocess import wrt as jwrt
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.preprocess import wrt
from cmix_tpu_torch.utils.profiling import GATE_SETS, LEAN, Meter

torch.set_num_threads(1)

MEDIA = ("testdata/media/grace_hopper.jpg", "testdata/media/signal16.wav")
BLOCK = 8192


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_media_job_segments_and_block_fields_match_the_jax_package(
        monkeypatch):
    monkeypatch.delenv("CMIX_JPEGC", raising=False)
    data = b"".join(_read(p) for p in MEDIA)
    payload, meta = wrt.transform(data)
    ref_payload, ref_meta = jwrt.transform(data, None)
    assert payload == ref_payload and meta == [tuple(e) for e in ref_meta]
    assert len(data) == 112534 and len(payload) == 519309
    assert [e[:4] for e in meta] == [(wrt.SEG_JPEGC, 468081, 61306, 64),
                                     (wrt.SEG_RAW, 44, 44),
                                     (wrt.SEG_AUDIO, 51184, 51184, 4)]
    nb = -(-len(payload) // BLOCK)
    assert nb == 64
    strides = wrt.block_strides(meta, nb, BLOCK)
    kinds = wrt.block_kinds(meta, nb, BLOCK)
    rel0, clen = wrt.block_jpeg_coords(meta, nb, BLOCK)
    for got, want in ((strides, jwrt.block_strides(ref_meta, nb, BLOCK)),
                      (kinds, jwrt.block_kinds(ref_meta, nb, BLOCK)),
                      (rel0, jwrt.block_jpeg_coords(ref_meta, nb, BLOCK)[0]),
                      (clen, jwrt.block_jpeg_coords(ref_meta, nb, BLOCK)[1])):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    jpeg = rel0 > np.iinfo(np.int32).min
    assert jpeg.sum() == 57 and not jpeg[57:].any()
    assert (strides[:57] == 64).all() and (strides[57:] == 4).all()
    assert (kinds[:57] == wrt.SEG_JPEGC).all()
    assert (kinds[57:] == wrt.SEG_AUDIO).all()
    assert runner._routed_gates(meta, False, None) == {
        "JPEGX": 1, "GRID2": 1, "X86X": 0, "JVAL": 0, "WRTW": 0, "LMS": 2}


# the routed fixture's JPEG (1,078 B, recoded to 1,421 B of planes) at the
# smallest step: the cost on the CPU goes with the payload's bytes
TINY = E.EngineConfig(block_size=32, tbits=10, mbits=10, ibits=10, pbits=10,
                      lstm_hidden=0, dmc_nodes=0)
TINY_COUNTS = {"in_bytes": 1078, "payload_bytes": 1421,
               "seg_bytes.jpegc": 1421, "lanes.jpegc": 45}


@pytest.fixture(scope="module")
def tiny(monkeypatch_module):
    """The JPEG coded without a Meter and with one, and the archive
    decoded with one -> (input, archive, encode's Meter, decode's)."""
    monkeypatch_module.delenv("CMIX_JPEGC", raising=False)
    data = _read("testdata/routed.raw")[2274:]
    kw = dict(max_batch=64, gates=LEAN, device="cpu")
    arc = runner.compress(data, TINY, **kw)
    enc, dec = Meter(), Meter()
    assert runner.compress(data, TINY, meter=enc, **kw) == arc
    assert runner.decompress(arc, device="cpu", meter=dec) == data
    return data, arc, enc, dec


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_tiny_routed_archive_routes_the_jpeg(tiny):
    arc, off = tiny[1], 4 + runner._HDR_LEN
    glen = int.from_bytes(arc[off:off + 2], "little")
    g = E.gates_from_blob(arc[off + 2:off + 2 + glen])
    assert (g.jpegx, g.grid2, g.lms) == (1, 1, 0)


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_routed_call_counts_its_payload(tiny, side):
    """Both directions count the same: encode from the transform, decode
    from the header and the segment table."""
    m = tiny[2] if side == "enc" else tiny[3]
    assert list(m.counts) == [0]
    assert m.counts[0] == TINY_COUNTS
    assert m.report()["counts"] == TINY_COUNTS
    assert m.export()["counts"] == {"0": TINY_COUNTS}


@pytest.mark.parametrize("side,name", [("enc", "jpeg_recode"),
                                       ("dec", "jpeg_restore")])
def test_jpeg_span_nests_under_transform(tiny, side, name):
    m = tiny[2] if side == "enc" else tiny[3]
    found = [s for s in m.spans if s.name == name]
    assert len(found) == 1
    parent = m.spans[found[0].parent]
    assert parent.name == "transform"
    assert m.spans[parent.parent].name == ("compress" if side == "enc"
                                           else "decompress")
    assert parent.start_ns <= found[0].start_ns <= found[0].end_ns \
        <= parent.end_ns
    assert not [s for s in m.spans
                if s.name in ("jpeg_recode", "jpeg_restore")
                and s.name != name]


# where one byte step marks its parts (predict's start and copyback's are
# make_static_step's): the record grid's contexts (GRID2, JPEGX) and the
# LMS's prediction inside predict, the LMS's two updates inside update
def _marks(grid, lms):
    return ([E.ROUTED, "predict"] * (grid + lms) + ["coder", "update"]
            + [E.ROUTED, "update", E.ROUTED] * lms + ["state", "lstm"])


@pytest.mark.parametrize("gates,grid,lms", [
    ({}, False, False),
    ({"PORT": 1}, False, False),
    ({"X86X": 2}, False, False),
    ({"GRID2": 1}, True, False),
    ({"JPEGX": 1, "PORT": 1}, True, False),
    ({"LMS": 2}, False, True),
    (GATE_SETS["routed"], True, True),
])
def test_step_marks_its_routed_work_only_with_a_routed_gate(gates, grid,
                                                            lms):
    cfg = E.EngineConfig(block_size=16, tbits=10, mbits=10, ibits=10,
                         pbits=10, lstm_hidden=0, dmc_nodes=0)
    g, dev, b = E.make_gates(gates), torch.device("cpu"), 2
    marks = []
    step = E.make_byte_step(cfg, g, dev, part=marks.append)
    pb = E.init_perblock(cfg, g, b, dev)
    pb["blk_kind"].fill_(wrt.SEG_AUDIO)
    with torch.no_grad():
        step(E.init_shared(cfg, g, dev), pb, E.init_coder(b, dev),
             torch.zeros((b, cfg.comp_size), dtype=torch.uint8),
             torch.tensor([65, 200], dtype=torch.uint8),
             torch.tensor(3, dtype=torch.int64),
             torch.full((b,), E.MODE_ENCODE, dtype=torch.int64))
    assert marks == _marks(grid, lms)
