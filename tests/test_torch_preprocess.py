"""The port's content detection (its own copy of cmix_tpu/preprocess's) vs
the JAX package's, on every file in testdata/ (the transforms themselves:
tests/test_torch_transform.py)."""

import glob

import numpy as np
import pytest

from cmix_tpu.preprocess import media as jmedia
from cmix_tpu.preprocess import wrt as jwrt
from cmix_tpu_torch.preprocess import media, wrt

FILES = sorted(glob.glob("testdata/*.raw") + glob.glob("testdata/media/*"))


def _spans(mod, data):
    return [(s.kind, s.data_off, s.data_len, s.stride)
            for s in mod.find_media_spans(data)]


@pytest.mark.parametrize("path", FILES)
def test_detection_matches(path):
    with open(path, "rb") as f:
        data = f.read()
    assert _spans(media, data) == _spans(jmedia, data)
    for lo in range(0, len(data), 65536):
        chunk = data[lo:lo + 65536]
        assert np.array_equal(wrt.detect_text_chunks(chunk, len(chunk)),
                              jwrt.detect_text_chunks(chunk, len(chunk)))
        assert wrt.exe_score(chunk) == jwrt.exe_score(chunk)
    # the detected segments that get a transform or a route are exactly
    # the JAX transform's non-raw segments (text without a dictionary
    # stays raw; a detected JPEG becomes SEG_JPEGC when it recodes)
    _, meta = jwrt.transform(data, None)
    routed = {wrt.SEG_EXE, wrt.SEG_IMG24, wrt.SEG_IMG8, wrt.SEG_AUDIO,
              wrt.SEG_JPEG}
    port = [t for t, _, _, _ in wrt.segments(data) if t in routed]
    ref = [e[0] for e in meta if e[0] != jwrt.SEG_RAW]
    assert len(port) == len(ref)
    if path.endswith(("exe100k.raw", ".bmp", ".wav", ".jpg")):
        assert port
