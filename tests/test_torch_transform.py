"""The port's content transforms and segment-table fields vs the JAX
package's: ``transform`` (payload bytes and meta entries), its exact inverse
``untransform``, and the per-block ``block_strides``, ``block_kinds`` and
``block_jpeg_coords``, on every file in testdata/, the routed fixture and
four PIL JPEGs; and the E8/E9 transform against the JAX package's (its
native library where that builds) on exe100k.raw."""

import glob

import pytest

from cmix_tpu.preprocess import jpeg as jjpeg
from cmix_tpu.preprocess import wrt as jwrt
from cmix_tpu_torch.preprocess import jpeg, wrt
from torch_parity import make_jpeg, transform_parity

FILES = sorted(glob.glob("testdata/*.raw") + glob.glob("testdata/media/*"))


def _check(data, monkeypatch, expect=None):
    monkeypatch.delenv("CMIX_JPEGC", raising=False)   # the JAX default
    meta = transform_parity(data)
    if expect is not None:
        assert expect <= {e[0] for e in meta}
    return meta


@pytest.mark.parametrize("path", FILES + ["testdata/routed.raw"])
def test_transform_matches_jax(path, monkeypatch):
    with open(path, "rb") as f:
        data = f.read()
    expect = {"exe100k.raw": {wrt.SEG_EXE},
              "bench4m.raw": {wrt.SEG_EXE},
              "photo24.bmp": {wrt.SEG_IMG24},
              "photo8.bmp": {wrt.SEG_IMG8},
              "terrain8.bmp": {wrt.SEG_IMG8},
              "signal16.wav": {wrt.SEG_AUDIO},
              "grace_hopper.jpg": {wrt.SEG_JPEGC},
              "routed.raw": {wrt.SEG_EXE, wrt.SEG_IMG24, wrt.SEG_AUDIO,
                             wrt.SEG_JPEGC}}.get(path.split("/")[-1])
    _check(data, monkeypatch, expect)


@pytest.mark.parametrize("kw", [
    dict(mode="L", quality=80),
    dict(mode="RGB", quality=90),
    dict(mode="RGB", quality=60, subsampling=2),
    dict(mode="RGB", quality=75, restart_marker_blocks=2),
])
def test_pil_jpegs_recode_as_jax(kw, monkeypatch):
    try:
        jp = make_jpeg(**kw)
    except TypeError:
        pytest.skip("PIL lacks restart_marker_blocks")
    payload = jpeg.jpeg_recode(jp)
    assert payload is not None and payload == jjpeg.jpeg_recode(jp)
    assert jpeg.jpeg_unrecode(payload) == jp
    assert jpeg.recoded_geometry(payload) == jjpeg.recoded_geometry(payload)
    assert jpeg.jpeg_stride(jp) == jjpeg.jpeg_stride(jp)
    # inside a stream of text, as the detector meets it (it takes a JPEG
    # of 1 KiB or more)
    data = b"some text around it " * 120 + jp + b" and a tail" * 30
    _check(data, monkeypatch, {wrt.SEG_JPEGC} if len(jp) >= 1024 else None)


def test_exe_transform_matches_jax():
    with open("testdata/exe100k.raw", "rb") as f:
        data = f.read()
    enc = wrt.exe_encode(data)
    assert enc != data and enc == jwrt.exe_encode(data)
    assert enc == jwrt._exe_py(data, True)
    assert wrt.exe_decode(enc) == data == jwrt.exe_decode(enc)
    # a segment whose end cuts an operand: the last 4 bytes never start one
    cut = data[:1000] + b"\xE8\x10\x00"
    assert wrt.exe_decode(wrt.exe_encode(cut)) == cut
    assert wrt.exe_encode(cut) == jwrt.exe_encode(cut)
