"""Dictionary mode on top of the content-routed gates: the routed fixture's
x86 code (no text) coded with a dictionary under PORT=1 at tiny widths.
WRTW=1 is routed whatever the transform (the payload was transformed and a
dictionary given), so the archive carries X86X=2 and WRTW=1 and the replay
runs under that ensemble; the port writes the JAX package's archive (the
golden ``dict_routed``; ``RUN_SLOW=1 pytest tests/test_torch_goldens.py``
re-derives it) and decodes it.  ``make_gates`` takes WRTW on top of every
gate set the port runs."""

import struct

import pytest

from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils import checkpoint
from torch_parity import jax_golden

TINY = dict(block_size=16, seg_size=16, tbits=10, mbits=10, ibits=8,
            pbits=10, lstm_hidden=8, lstm_horizon=2, dmc_nodes=4096)


@pytest.mark.parametrize("env", [
    {"WRTW": 1}, {"WRTW": 2}, dict(E.BENCH_GATES, WRTW=1),
    {"PORT": 1, "ILSTM_LRX": 2, "ILSTM_ADAM": 1, "WRTW": 1},
    {"X86X": 2, "GRID2": 1, "LMS": 2, "JPEGX": 1, "WRTW": 1},
    dict(E.BENCH_GATES, X86X=2, WRTW=3)])
def test_wrtw_is_accepted_on_every_gate_set(env):
    g = E.make_gates(env)
    assert g.wrtw == env["WRTW"]
    assert f"WRTW={env['WRTW']}".encode() in g.blob().split(b";")
    assert E.gates_from_blob(g.blob()) == g
    assert g.n_bank == E.make_gates(dict(env, WRTW=0)).n_bank


def test_routed_content_with_a_dictionary_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "CACHE_DIR", str(tmp_path / "port"))
    # the routed fixture's x86 part (torch_parity.make_routed_input), and
    # mini.dic's first 20 words (72 B: an 80-step replay at 16-byte blocks)
    with open("testdata/exe100k.raw", "rb") as f:
        data = f.read()[36864:36864 + 768]
    dic = tmp_path / "words.dic"
    with open("testdata/mini.dic", "rb") as f:
        dic.write_bytes(b"".join(f.readlines()[:20]))
    aj = jax_golden("dict_routed", data, config=TINY, gates={"PORT": 1},
                    dictionary=str(dic))
    at = runner.compress(data, E.EngineConfig(**TINY), dictionary=str(dic),
                         gates={"PORT": 1}, device="cpu")
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", at[off:off + 2])[0]
    assert at[off + 2:off + 2 + glen] == b"X86X=2;WRTW=1;PORT=1"
    assert at[5] == 3 and at == aj
    assert runner.decompress(aj, dictionary=str(dic), device="cpu") == data
