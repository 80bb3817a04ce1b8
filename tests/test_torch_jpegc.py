"""``CMIX_JPEGC`` in the port's content transforms, against the JAX
package's: unset, "1" and "2" recode a JPEG span, "0" keeps it as a
pass-through ``SEG_JPEG`` entry.  Under each value both packages'
``transform`` give the same payload and segment table, ``untransform``
inverts it exactly, the per-block fields are equal, and under "0" the
routed gates lose JPEGX and JVAL (also with JVAL_ROUTE set) and keep GRID2
and X86X.  Host code only: no JAX compile.  (The port once recoded every
JPEG whatever the switch said.)"""

import pytest

from cmix_tpu_torch import runner
from cmix_tpu_torch.preprocess import wrt
from torch_parity import make_jpeg, transform_parity

VALUES = (None, "1", "0", "2")
BLOCKS = (128, 4096, 65536)


def _set(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("CMIX_JPEGC", raising=False)
    else:
        monkeypatch.setenv("CMIX_JPEGC", value)


def _both(data, value, monkeypatch):
    _set(monkeypatch, value)
    return transform_parity(data, BLOCKS)


@pytest.mark.parametrize("value", VALUES)
def test_routed_fixture_transform_follows_the_switch(value, monkeypatch):
    with open("testdata/routed.raw", "rb") as f:
        data = f.read()
    meta = _both(data, value, monkeypatch)
    if value == "0":
        assert meta[-1] == (wrt.SEG_JPEG, 1078, 1078)
        assert wrt.SEG_JPEGC not in {e[0] for e in meta}
    else:
        assert meta[-1][0] == wrt.SEG_JPEGC and meta[-1][2] == 1078


@pytest.mark.parametrize("value", VALUES)
@pytest.mark.parametrize("kw", [dict(mode="L", quality=80),
                                dict(mode="RGB", quality=60, subsampling=2)])
def test_pil_jpegs_follow_the_switch(value, kw, monkeypatch):
    # 128 x 96: over the 1 KiB the detector takes
    jp = make_jpeg(128, 96, **kw)
    assert len(jp) >= 1024
    # inside a stream of text, as the detector meets it
    data = b"some text around it " * 120 + jp + b" and a tail" * 30
    meta = _both(data, value, monkeypatch)
    jpegs = [e for e in meta if e[0] in (wrt.SEG_JPEG, wrt.SEG_JPEGC)]
    assert len(jpegs) == 1 and jpegs[0][2] == len(jp)
    if value == "0":
        assert jpegs[0] == (wrt.SEG_JPEG, len(jp), len(jp))
    else:
        assert jpegs[0][0] == wrt.SEG_JPEGC


@pytest.mark.parametrize("jval_route", [None, "1"])
def test_routed_gates_without_recoding(jval_route, monkeypatch):
    with open("testdata/routed.raw", "rb") as f:
        data = f.read()
    if jval_route is None:
        monkeypatch.delenv("JVAL_ROUTE", raising=False)
    else:
        monkeypatch.setenv("JVAL_ROUTE", jval_route)
    _set(monkeypatch, "0")
    _, meta = wrt.transform(data)
    port = runner._routed_gates(meta, True, None)
    assert (port["JPEGX"], port["JVAL"], port["GRID2"], port["X86X"]) == (
        0, 0, 1, 2)
    assert port["LMS"] == 0 and port["WRTW"] == 0
    # the fast profile routes LMS for the BMP and the WAV as before
    assert runner._routed_gates(meta, False, None)["LMS"] == 2
    # recoding on: JPEGX back, JVAL with it as JVAL_ROUTE says
    _set(monkeypatch, "1")
    _, meta = wrt.transform(data)
    on = runner._routed_gates(meta, True, None)
    assert on["JPEGX"] == 1 and on["JVAL"] == int(jval_route or 0)
