"""The port's host copy of the enwik9 tool (cmix_tpu_torch/preprocess/
enwik9.py) against cmix_tpu/preprocess/enwik9.py on tests/test_enwik9.py's
mini-wiki: the same orders and containers, each package decoding the
other's, and both CLIs."""

import subprocess
import sys

import pytest

from cmix_tpu.preprocess import enwik9 as J
from cmix_tpu_torch.preprocess import enwik9 as T
from test_enwik9 import _mini_wiki

ORDER = [5, 0, 9, 2, 1, 3]


@pytest.mark.parametrize("data", [
    _mini_wiki(), _mini_wiki(n=6, redirects=(1, 4)), _mini_wiki()[:-3], b"",
    b"no pages here at all", b"  <page>\nunterminated", b"\x00\xff" * 100],
    ids=["wiki", "wiki6", "cut", "empty", "no_pages", "unterminated",
         "binary"])
@pytest.mark.parametrize("order", [None, ORDER, "semantic"],
                         ids=["none", "given", "semantic"])
def test_same_container_both_ways(data, order):
    if order == "semantic":
        order = J.make_semantic_order(data)
        assert T.make_semantic_order(data) == order
    assert T.make_remap_order(data) == J.make_remap_order(data)
    if order and max(order) >= len(J.split_pages(data)[1]):
        order = None
    blob = T.encode(data, order)
    assert blob == J.encode(data, order)
    assert T.decode(blob) == J.decode(blob) == data


def _cli(pkg, *args):
    subprocess.run([sys.executable, "-m", f"{pkg}.preprocess.enwik9",
                    *map(str, args)], check=True, capture_output=True)


def test_both_clis_decode_each_other(tmp_path):
    src = tmp_path / "wiki.xml"
    src.write_bytes(_mini_wiki())
    pkgs = ("cmix_tpu_torch", "cmix_tpu")
    for a, b in (pkgs, pkgs[::-1]):
        orderf, enc, dec = (tmp_path / f"{a}.{x}"
                            for x in ("ord", "w9", "out"))
        _cli(a, "remap", src, orderf)
        _cli(a, "c", src, enc, "--order", orderf)
        _cli(b, "d", enc, dec)
        assert dec.read_bytes() == src.read_bytes()
    assert ((tmp_path / "cmix_tpu_torch.w9").read_bytes()
            == (tmp_path / "cmix_tpu.w9").read_bytes())
    assert ((tmp_path / "cmix_tpu_torch.ord").read_bytes()
            == (tmp_path / "cmix_tpu.ord").read_bytes())
