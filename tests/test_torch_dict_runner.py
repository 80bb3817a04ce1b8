"""Dictionary mode (WRT + pretraining) under PORT=1 across the two packages
on the CPU: testdata/mini.dic, 512 bytes of text in 64-byte blocks at exec
batch 3 (three coding groups, the last padded), small widths.  Both
packages write the same archive byte for byte (flags 3, gate record
WRTW=1;PORT=1, the dictionary's fingerprint in the header; the JAX
package's is the golden ``dict_runner``) and the port decodes it; the
archives being equal, ``RUN_SLOW=1 pytest tests/test_torch_goldens.py`` has
the JAX package decode it.  A missing or another dictionary is a
FormatError, and a dictionary given for an archive coded without one is
ignored."""

import hashlib
import struct

import pytest

from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils import checkpoint
from torch_parity import RUNNER_KW, jax_golden

DIC = "testdata/mini.dic"


def dict_input():
    with open("testdata/text100k.raw", "rb") as f:
        return f.read()[:512]


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """(input, the JAX package's archive, the port's, the port's decode of
    the JAX package's), the port with a pretraining cache in a fresh
    directory."""
    data = dict_input()
    aj = jax_golden("dict_runner", data, config=RUNNER_KW, gates={"PORT": 1},
                    max_batch=3, dictionary=DIC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint, "CACHE_DIR",
                   str(tmp_path_factory.mktemp("port")))
        at = runner.compress(data, E.EngineConfig(**RUNNER_KW), max_batch=3,
                             dictionary=DIC, gates={"PORT": 1}, device="cpu")
        back_t = runner.decompress(aj, dictionary=DIC, device="cpu")
        yield data, aj, at, back_t


def test_portable_dict_archives_are_byte_identical(archives):
    data, aj, at, back_t = archives
    assert at == aj
    assert at[5] == 3                       # WRT segment table + pretrained
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", at[off:off + 2])[0]
    assert at[off + 2:off + 2 + glen] == b"WRTW=1;PORT=1"
    hdr = struct.unpack(runner._HDR, at[4:off])
    with open(DIC, "rb") as f:
        assert hdr[16] == hashlib.sha256(f.read()).digest()[:8]
    assert hdr[12] == 3 and hdr[15] > 6     # exec batch 3, three groups
    assert back_t == data                   # the port decodes the JAX's


def test_missing_or_other_dictionary_is_a_format_error(archives):
    aj = archives[1]
    with pytest.raises(E.FormatError, match="requires the dictionary"):
        runner.decompress(aj, device="cpu")
    with pytest.raises(E.FormatError, match="fingerprint mismatch"):
        runner.decompress(aj, dictionary="auto", device="cpu")
    with pytest.raises(OSError):
        runner.decompress(aj, dictionary="testdata/no_such.dic",
                          device="cpu")


def test_auto_is_the_ports_own_copy_of_the_shipped_list():
    d, dict_bytes, fp, tables = runner._load_dictionary("auto")
    assert runner.AUTO_DICT.endswith("cmix_tpu_torch/data/english.dic")
    with open(runner.AUTO_DICT, "rb") as f:
        assert dict_bytes == f.read()
    assert fp == hashlib.sha256(dict_bytes).digest()[:8]
    assert len(d.words) == 10069 and tables[0][:len(d.words)].all()


def test_a_dictionary_is_ignored_for_an_archive_coded_without_one():
    tiny = E.EngineConfig(block_size=16, seg_size=16, tbits=10, mbits=10,
                          ibits=8, pbits=10, lstm_hidden=8, lstm_horizon=2,
                          dmc_nodes=4096)
    arc = runner.compress(b"", tiny, device="cpu")
    assert arc[5] == 0
    for dictionary in ("auto", "testdata/no_such.dic"):
        assert runner.decompress(arc, dictionary=dictionary,
                                 device="cpu") == b""
