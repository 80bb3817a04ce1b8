"""The --resume journal (``runner._resume_key``/``_resume_load``/
``_resume_save``, the JAX package's TCMR format) on the CPU, as
tests/test_roundtrip.py::test_resume_journal holds the JAX package's: a run
whose saver raises after the first coding group leaves a journal of whole
groups, and the resumed run skips them and writes the uninterrupted
archive; a torn tail is dropped; a journal of another payload, another
gate set or, in the fast profile, another device type is ignored (the
port's key hashes the gate record and that device type beside the JAX
package's fields); the journal goes once the archive is whole."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner

CFG = E.EngineConfig(block_size=16, seg_size=16, tbits=10, mbits=10,
                     ibits=8, pbits=10, lstm_hidden=8, lstm_horizon=2,
                     dmc_nodes=4096)
EB = 2                                  # 5 blocks: groups of 2, 2 and 1
CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def _data():
    rng = np.random.default_rng(9)
    words = [b"alpha", b"beta", b"gamma", b"delta "]
    return b" ".join(words[i] for i in rng.integers(0, 4, 14))[:80]


@pytest.fixture
def groups(monkeypatch):
    """The coding groups each compress codes (a list of counts, one per
    call of the runner's transcoder factory)."""
    seen = []
    orig = runner.make_transcoder

    def counting(*a, **kw):
        trans = orig(*a, **kw)
        seen.append(0)

        def run(*b, **k):
            seen[-1] += 1
            return trans(*b, **k)
        return run
    monkeypatch.setattr(runner, "make_transcoder", counting)
    return seen


def _interrupted(tmp_path, monkeypatch, gates=None):
    """A compress whose journal saver raises after the first group."""
    jp = str(tmp_path / "job.tcmr")
    real = runner._resume_save

    def crashing_save(path, key, streams):
        real(path, key, streams)
        raise KeyboardInterrupt
    monkeypatch.setattr(runner, "_resume_save", crashing_save)
    with pytest.raises(KeyboardInterrupt):
        runner.compress(_data(), CFG, max_batch=EB, gates=gates,
                        device="cpu", resume_path=jp)
    monkeypatch.setattr(runner, "_resume_save", real)
    return jp


@pytest.mark.parametrize("gates", [None, {"PORT": 1}], ids=["fast", "port"])
def test_interrupted_run_resumes_to_the_uninterrupted_archive(
        tmp_path, monkeypatch, groups, gates):
    data = _data()
    full = runner.compress(data, CFG, max_batch=EB, gates=gates,
                           device="cpu")
    jp = _interrupted(tmp_path, monkeypatch, gates)
    key = runner._resume_key(data, CFG, EB, 0, E.make_gates(gates), CPU)
    assert len(runner._resume_load(jp, key)) == EB    # the first group
    resumed = runner.compress(data, CFG, max_batch=EB, gates=gates,
                              device="cpu", resume_path=jp)
    assert groups == [3, 1, 2]                        # full, crash, resume
    assert resumed == full
    assert not (tmp_path / "job.tcmr").exists()
    assert runner.decompress(resumed, device="cpu") == data


def test_torn_tail_and_partial_groups_are_dropped(tmp_path, monkeypatch,
                                                  groups):
    data = _data()
    full = runner.compress(data, CFG, max_batch=EB, device="cpu")
    jp = _interrupted(tmp_path, monkeypatch)
    key = runner._resume_key(data, CFG, EB, 0, E.make_gates(), CPU)
    first = runner._resume_load(jp, key)
    # a third stream (half a group) and a torn fourth record
    runner._resume_save(jp, key, first + [(False, b"junk")])
    with open(jp, "ab") as f:
        f.write(b"\x00\xff\xff\x00\x00ab")
    assert len(runner._resume_load(jp, key)) == 3
    assert runner.compress(data, CFG, max_batch=EB, device="cpu",
                           resume_path=jp) == full
    assert groups == [3, 1, 2]


@pytest.mark.parametrize("case", ["payload", "gates", "device"])
def test_journals_of_another_run_are_ignored(tmp_path, groups, case):
    """A journal of junk streams under another payload's key, another gate
    set's, or (fast profile) another device type's: the run recomputes every
    group and writes the uninterrupted archive."""
    data = _data()
    full = runner.compress(data, CFG, max_batch=EB, device="cpu")
    g, payload, dev = E.make_gates(), data, CPU
    if case == "payload":
        payload = data[:-1] + b"z"
    elif case == "gates":
        g = E.make_gates({"MIX_LR": 2e-3})
    else:
        dev = CUDA
    jp = str(tmp_path / "job.tcmr")
    runner._resume_save(jp, runner._resume_key(payload, CFG, EB, 0, g, dev),
                        [(False, b"junk")] * 4)
    assert runner.compress(data, CFG, max_batch=EB, device="cpu",
                           resume_path=jp) == full
    assert groups == [3, 3]


def test_portable_journal_carries_across_device_types():
    """Under PORT=1 the key holds no device type: a journal written on the
    card is trusted on the CPU (its archives decode on any device)."""
    data = _data()
    gates = {"PORT": 1}
    g = E.make_gates(gates)
    assert (runner._resume_key(data, CFG, EB, 0, g, CUDA)
            == runner._resume_key(data, CFG, EB, 0, g, CPU))
    assert (runner._resume_key(data, CFG, EB, 0, E.make_gates(), CUDA)
            != runner._resume_key(data, CFG, EB, 0, E.make_gates(), CPU))


def test_cli_resume_round_trip(tmp_path):
    src, arc, back = tmp_path / "in.txt", tmp_path / "a.tcmx", tmp_path / "b"
    jp = tmp_path / "job.tcmr"
    src.write_bytes(_data())
    small = ["--device", "cpu", "--block-size", "16", "--tbits", "10",
             "--lstm", "8", "--dmc", "4096", "--max-batch", "2"]
    runner.main(["c", str(src), str(arc), "--resume", str(jp)] + small)
    assert not jp.exists()
    runner.main(["d", str(arc), str(back), "--device", "cpu"])
    assert back.read_bytes() == src.read_bytes()
