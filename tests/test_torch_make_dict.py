"""The port's host copies of the dictionary builder (cmix_tpu_torch/tools/
make_dict.py, core_words.py) against cmix_tpu/tools/: the same head, word
counts and frequency-ordered lists on the same corpora, and both CLIs
writing the same file."""

import subprocess
import sys

import pytest

from cmix_tpu.tools import core_words as JC
from cmix_tpu.tools import make_dict as JM
from cmix_tpu_torch.tools import core_words as TC
from cmix_tpu_torch.tools import make_dict as TM

CORPORA = ["testdata/text100k.raw", "README.md", "ROADMAP.md",
           "testdata/gated.raw"]


def _blobs():
    out = []
    for p in CORPORA:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def test_core_list():
    assert TC.CORE_WORDS == JC.CORE_WORDS
    assert TC.core_list() == JC.core_list()
    assert len(TC.core_list()) > 300


@pytest.mark.parametrize("kw", [
    {}, {"core": False}, {"min_docs": 2, "max_words": 3000},
    {"min_count": 5, "min_len": 3, "max_words": 500}],
    ids=["default", "no_core", "min_docs", "counts"])
def test_build_dictionary(kw):
    blobs = _blobs()
    assert TM.count_words(blobs) == JM.count_words(blobs)
    words = TM.build_dictionary(blobs, **kw)
    assert words == JM.build_dictionary(blobs, **kw)
    assert len(words) == len(set(words)) > 100


def test_cli_writes_the_jax_packages_list(tmp_path):
    """The port's CLI writes the JAX package's ``build_dictionary`` list as
    tools/rebuild_dict.py writes it.  The JAX package's own CLI joins the
    str words as bytes and raises TypeError (ROADMAP.md section 3), so it
    writes no file."""
    args = [*CORPORA, "--min-docs", "2", "--max-words", "2000"]
    runs = {}
    for pkg in ("cmix_tpu", "cmix_tpu_torch"):
        out = tmp_path / f"{pkg}.dic"
        runs[pkg] = subprocess.run(
            [sys.executable, "-m", f"{pkg}.tools.make_dict", str(out),
             *args], capture_output=True, text=True)
    assert runs["cmix_tpu_torch"].returncode == 0
    assert runs["cmix_tpu"].returncode != 0
    assert "TypeError" in runs["cmix_tpu"].stderr
    want = JM.build_dictionary(_blobs(), max_words=2000, min_docs=2)
    got = (tmp_path / "cmix_tpu_torch.dic").read_bytes()
    assert got == ("\n".join(want) + "\n").encode()
    assert got.count(b"\n") == len(want) > 300
