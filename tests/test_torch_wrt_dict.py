"""The port's WRT dictionary transform vs the JAX package's: the word list
parse, ``Dictionary.encode`` against the JAX package's native library and
its Python twin (text, capitalized and upper-case words, escaped bytes),
``decode`` as its inverse, and ``transform``/``untransform`` with
english.dic on every file in testdata/; the port's dictionary files."""

import glob

import pytest

from cmix_tpu.preprocess import wrt as jwrt
from cmix_tpu_torch import runner
from cmix_tpu_torch.preprocess import wrt

JAX_DIC = "cmix_tpu/data/english.dic"
DICS = {"english": (runner.AUTO_DICT, JAX_DIC),
        "mini": ("testdata/mini.dic", "testdata/mini.dic")}


def _text(n=100000, off=0):
    with open("testdata/text100k.raw", "rb") as f:
        return f.read()[off:off + n]


def _inputs():
    text = _text()
    return {
        "text100k": text,
        "capitalized": text[:20000].title(),
        "upper": text[20000:40000].upper(),
        "escapes": (bytes(range(256)) + b"\x04\x05\x06 The THE the "
                    + bytes(range(0x80, 0x100)) + b"Ab aB AB ab \x04x\x05"
                    + text[:2000] + b"\x04"),
    }


@pytest.mark.parametrize("name", sorted(DICS))
def test_word_list_matches_jax(name):
    port, ref = DICS[name]
    d, j = wrt.Dictionary(port), jwrt.Dictionary(ref)
    assert d.words == j.words and d.ids == j.ids
    assert len(d.words) == (10069 if name == "english" else 128)


@pytest.mark.parametrize("what", sorted(_inputs()))
def test_encode_matches_jax_native_and_twin(what):
    data = _inputs()[what]
    d, j = wrt.Dictionary(runner.AUTO_DICT), jwrt.Dictionary(JAX_DIC)
    enc = d.encode(data)
    assert enc == j._encode_py(data)
    assert enc == j.encode(data)              # native where it builds
    assert d.decode(enc) == data == j.decode(enc)
    if what != "escapes":
        assert len(enc) < len(data)
    else:                                     # every byte >= 0x80 escaped
        assert enc.count(wrt.ESC) >= 128


def test_decode_truncated_and_unknown_codewords_match_the_twin():
    d, j = wrt.Dictionary("testdata/mini.dic"), jwrt.Dictionary(
        "testdata/mini.dic")
    for data in (b"a\xc0", b"\xf0\x01", b"\xbf\xee\x00\x01 x \x05\x81\x06",
                 b"\xf3\x00\x00\x04"):
        assert d.decode(data) == j._decode_py(data)


@pytest.mark.parametrize("path", sorted(glob.glob("testdata/*.raw")))
def test_transform_with_dictionary_matches_jax(path, monkeypatch):
    monkeypatch.delenv("CMIX_JPEGC", raising=False)   # the JAX default
    with open(path, "rb") as f:
        data = f.read()
    d, j = wrt.Dictionary(runner.AUTO_DICT), jwrt.Dictionary(JAX_DIC)
    payload, meta = wrt.transform(data, d)
    ref_payload, ref_meta = jwrt.transform(data, j)
    assert payload == ref_payload
    assert meta == [tuple(e) for e in ref_meta]
    assert wrt.untransform(payload, meta, d) == data
    assert jwrt.untransform(payload, meta, j) == data
    if "text" in path:
        assert meta[0][0] == wrt.SEG_TEXT and meta[0][1] < meta[0][2]


def test_text_segment_without_dictionary_is_a_format_error():
    from cmix_tpu_torch.engine import FormatError
    d = wrt.Dictionary("testdata/mini.dic")
    payload, meta = wrt.transform(_text(4096), d)
    assert meta[0][0] == wrt.SEG_TEXT
    with pytest.raises(FormatError, match="dictionary"):
        wrt.untransform(payload, meta)


def test_port_dictionary_files():
    with open(runner.AUTO_DICT, "rb") as f:
        port = f.read()
    with open(JAX_DIC, "rb") as f:
        assert port == f.read() and len(port) == 79999
    with open("testdata/mini.dic", "rb") as f:
        mini = f.read()
    assert mini == b"".join(port.splitlines(keepends=True)[:128])
    assert len(mini) == 600
