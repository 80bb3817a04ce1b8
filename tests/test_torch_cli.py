"""The port's entry points on the CPU: the CLI round trip, raw-stored blocks
re-fed in a decode group, content-routed input, gate sets it once refused
(now accepted with the JAX package's widths), the --resume journal through
the runner, and the FormatErrors it shares with the JAX package."""

import struct

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu import engine as je
from cmix_tpu.preprocess import wrt as jwrt
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.preprocess import wrt
from torch_parity import jax_gates  # noqa: F401

SMALL = E.EngineConfig(block_size=64, seg_size=64, tbits=12, mbits=12,
                       ibits=10, pbits=12, lstm_hidden=32, lstm_horizon=4,
                       dmc_nodes=4096)
TINY = E.EngineConfig(block_size=16, seg_size=16, tbits=10, mbits=10,
                      ibits=8, pbits=10, lstm_hidden=8, lstm_horizon=2,
                      dmc_nodes=4096)


def _text(n, off=0):
    with open("testdata/text100k.raw", "rb") as f:
        return f.read()[off:off + n]


def _lens(archive, nb):
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", archive[off:off + 2])[0]
    end = off + 2 + glen
    return struct.unpack(f"<{nb}I", archive[end:end + 4 * nb])


def test_raw_stored_blocks_refed_in_decode_groups():
    # one text block, then every byte value once (full vocabulary: the four
    # random blocks cannot shrink and are stored raw); exec batch 3 gives a
    # decode group of one decode lane + two re-fed raw lanes, then a group
    # of two raw lanes + one dummy lane
    rnd = np.random.default_rng(3).permutation(256).astype(np.uint8)
    data = _text(64) + rnd.tobytes()
    arc = runner.compress(data, SMALL, max_batch=3, device="cpu")
    assert [L >> 31 for L in _lens(arc, 5)] == [0, 1, 1, 1, 1]
    assert runner.decompress(arc, device="cpu") == data


def test_cli_roundtrip_on_cpu(tmp_path, capsys):
    src, arc, back = tmp_path / "in.txt", tmp_path / "a.tcmx", tmp_path / "b"
    src.write_bytes(_text(128, 4000))
    small = ["--device", "cpu", "--block-size", "64", "--tbits", "10",
             "--lstm", "16", "--dmc", "4096"]
    runner.main(["t", str(src), str(arc)] + small)
    assert "cross entropy" in capsys.readouterr().out
    runner.main(["d", str(arc), str(back), "--device", "cpu"])
    assert back.read_bytes() == src.read_bytes()
    # the archive pins the widths: decode needs no flags but the device
    head = arc.read_bytes()[4:4 + runner._HDR_LEN]
    fields = struct.unpack(runner._HDR, head)
    assert fields[2] == 6 and fields[3] == 10 and fields[11] == 16


def test_empty_input_roundtrip():
    arc = runner.compress(b"", TINY, device="cpu")
    assert runner.decompress(arc, device="cpu") == b""


# gate sets the port refused until it ported the remaining gate values (the
# test keeps its name): now accepted with the JAX package's gate record and
# widths, and a round trip through the runner (which routes X86X and LMS
# from the content: 0 on text)
@pytest.mark.parametrize("gates", [
    {"X86X": 1}, {"PORT": 1, "CTX4": 0}, {"LMS": 1},
    {"MIX_NORM": 0},                     # a value knob
    {"CNT_CAP": 30},
    {"DMC_LEVELS": 7},                   # a part of the bench set alone
    dict(E.BENCH_GATES, CTX4=1),
    dict(E.BENCH_GATES, PORT=1),         # PORT on the bench gates
    dict(E.BENCH_GATES, SSE2=1)])        # a mechanism on the bench gates
def test_unported_gate_sets_raise(gates, jax_gates):
    jax_gates(gates)
    g = E.make_gates(gates)
    assert g.blob() == je.gates_blob()
    assert (g.n_bank, g.n_inputs, g.mix1_total, g.n_l2, g.n_apm,
            g.dmc_levels) == (je.N_BANK, je.N_INPUTS, je._MIX1_TOTAL,
                              je.N_L2, je.N_APM, min(je.dmc.DMC_LEVELS, 8))
    data = _text(64, 500)
    arc = runner.compress(data, TINY, gates=gates, device="cpu")
    routed = dict(gates, X86X=0, LMS=0)
    off = 4 + runner._HDR_LEN
    assert arc[off + 2:off + 2 + arc[off]] == E.make_gates(routed).blob()
    assert runner.decompress(arc, device="cpu") == data


def test_unknown_gate_is_a_format_error():
    with pytest.raises(E.FormatError):
        E.make_gates({"NO_SUCH_GATE": 1})


def test_lms_with_port_is_a_format_error():
    with pytest.raises(E.FormatError, match="PORT=1 requires"):
        E.make_gates({"LMS": 2, "PORT": 1})
    with pytest.raises(E.FormatError, match="PORT=1 requires"):
        runner.compress(_text(64), SMALL, gates={"LMS": 2, "PORT": 1},
                        device="cpu")


# content the port refused until it ported the content-routed path (the
# test keeps its name): now transformed as the JAX package transforms it
@pytest.mark.parametrize("path", ["testdata/exe100k.raw",
                                  "testdata/media/signal16.wav",
                                  "testdata/media/photo8.bmp",
                                  "testdata/media/grace_hopper.jpg"])
def test_unported_content_raises(path):
    with open(path, "rb") as f:
        data = f.read()
    payload, meta = wrt.transform(data)
    assert (payload, meta) == jwrt.transform(data, None)
    assert {e[0] for e in meta} - {wrt.SEG_RAW}
    assert wrt.untransform(payload, meta) == data


def test_routed_fixture_round_trips_at_tiny_widths():
    with open("testdata/routed.raw", "rb") as f:
        data = f.read()
    arc = runner.compress(data, TINY, device="cpu")
    assert arc[5] == runner._FLAG_WRT                 # a segment table
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    assert arc[off + 2:off + 2 + glen] == b"X86X=2;LMS=2;GRID2=1;JPEGX=1"
    assert runner.decompress(arc, device="cpu") == data


# the test keeps its name from when the port refused dictionaries: now a
# --dict round trip through the CLI, and the archive refused without it
def test_dictionary_resume_and_segmented_archives_raise(tmp_path,
                                                        monkeypatch):
    from cmix_tpu_torch.utils import checkpoint
    monkeypatch.setattr(checkpoint, "CACHE_DIR", str(tmp_path / "cache"))
    src, arc_path = tmp_path / "in.txt", tmp_path / "a.tcmx"
    src.write_bytes(_text(512))
    runner.main(["t", str(src), str(arc_path), "--device", "cpu",
                 "--block-size", "16", "--tbits", "10", "--lstm", "8",
                 "--dmc", "4096", "--dict", "testdata/mini.dic"])
    runner.main(["d", str(arc_path), str(tmp_path / "b"), "--device", "cpu",
                 "--dict", "testdata/mini.dic"])
    assert (tmp_path / "b").read_bytes() == src.read_bytes()
    arc = arc_path.read_bytes()
    assert arc[5] == runner._FLAG_WRT | runner._FLAG_PRETRAIN
    with pytest.raises(E.FormatError, match="requires the dictionary"):
        runner.main(["d", str(arc_path), str(tmp_path / "c"), "--device",
                     "cpu"])
    # --resume: a journalled compress writes the archive a plain one writes,
    # and removes its journal once the archive is whole
    journal = tmp_path / "j"
    plain = runner.compress(_text(64), TINY, max_batch=2, device="cpu")
    assert runner.compress(_text(64), TINY, max_batch=2, device="cpu",
                           resume_path=str(journal)) == plain
    assert not journal.exists()
    # flags bit 0 without the segment table it announces
    arc = bytearray(runner.compress(b"", TINY, device="cpu"))
    arc[5] = runner._FLAG_WRT
    hdr_end = 4 + runner._HDR_LEN + 2
    with pytest.raises(E.FormatError, match="segment table"):
        runner.decompress(bytes(arc[:hdr_end + 3]), device="cpu")


def test_non_power_of_two_dmc_pool_is_refused():
    cfg = E.EngineConfig(block_size=128, seg_size=128, tbits=12, mbits=12,
                         ibits=10, pbits=12, lstm_hidden=32, dmc_nodes=5120)
    with pytest.raises(E.FormatError, match="power of two"):
        runner.compress(_text(64), cfg, device="cpu")


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.compress(_text(64), SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.resolve_device()
