"""The frozen copies and counts at tiny sizes: dmc_fused's byte count,
the step's FLOP count, profile_steps' arithmetic, bench.py's digest."""

import hashlib

import numpy as np

from portbench.harness import check, counts, trace


def test_dmc_fused_bytes_by_hand():
    # 2 lanes, depth 2: cur (2) + 80 descriptor words a lane (uX, uXC: 24;
    # uS, uSW, uU, uUW: 8) + per lane 1 + 4 walked words and 4 + 4 + 2
    # output words -> 2 + 160 + 2 * 15 words of 4 bytes
    assert counts.dmc_fused_bytes(2, 2) == 4 * (2 + 160 + 30)
    assert counts.dmc_fused_bytes(2, 2, n_valid=5) == 4 * (2 + 160 + 5 + 30)


def test_dmc_descriptor_words_are_the_programs():
    import torch
    from cmix_tpu_torch.models import dmc
    pb = dmc.init_dmc_perblock(4096, 3, torch.device("cpu"))
    assert sum(pb[k].numel() for k in dmc.DMC_UPD_KEYS) == 3 * (
        2 * counts.N_UX + 4 * counts.N_UP)


def test_step_flops_by_hand():
    cfg = {"lstm_hidden": 2, "lstm_layers": 1, "lstm_horizon": 1}
    sizes = dict(n_inputs=3, n_mix1=2, m2in=2, n_l2=1, n_apm=1)
    # LSTM, gates 3 x 2 = 6: embedding 2*256*6 = 3072, wh 2*2*6 = 24, so a
    # cell is 3096; logits 2*2*256 = 1024; forward 4120; backward 2 *
    # (4120 - 3072) + 3072 = 5168; one horizon step plus two cells and
    # one logits: 9288 + 6192 + 1024 = 16504
    lstm = 16504
    # mixers: layer 1 2*3*256*2 = 3072, layer 2 2*2*256 = 1024, layer 3
    # 512, blend 2*2*256 = 1024, each forward and gradient: 2 * 5632;
    # APM reads 3*256 = 768, updates 2*2*8 = 32
    mix = 2 * 5632 + 768 + 32
    assert counts.lstm_flops(2, 1, 1) == lstm
    assert counts.step_flops(cfg, sizes, 3) == 3 * (lstm + mix)
    assert counts.step_flops(dict(cfg, lstm_hidden=0), sizes, 1) == mix


def test_ensemble_sizes_are_the_programs():
    from cmix_tpu_torch.engine import make_gates
    for gates in ({}, {"PORT": 1}, {"MIX_AUX": 1, "APM2X": 0}):
        g = make_gates(gates)
        assert counts.ensemble_sizes(gates) == dict(
            n_inputs=g.n_inputs, n_mix1=g.n_mix1, m2in=g.m2in, n_l2=g.n_l2,
            n_apm=g.n_apm)


def test_profile_arithmetic():
    device = [("k1", 0, 10), ("k2", 5, 20), ("k1", 30, 40)]
    host = [("cudaGraphLaunch", 18, 35), ("python", 0, 50)]
    s = trace.summarize(device, host, 2)
    assert s["busy_s"] == 30e-9
    assert s["window_s"] == 40e-9
    assert abs(s["idle_share"] - 0.25) < 1e-12
    assert s["ops_per_step"] == 1.5
    assert s["device_s"] == {"k1": 20e-9, "k2": 15e-9}
    assert s["device_ops"][0] == ["k1", 20e-9]
    assert s["idle_gaps"] == [["cudaGraphLaunch | before k1", 10e-9]]


def test_busy_and_wall_from_the_measured_replays():
    # the lead replay's operations (before the marker) are left out of
    # busy and wall alike; the share stays in [0, 1]
    lead = [("k1", 0, 10), ("k2", 10, 900)]
    replays = [("k1", 1000, 1010), ("k2", 1015, 1040), ("k1", 1100, 1110)]
    ops = trace.measured(lead + replays, 950)
    assert ops == replays
    s = trace.summarize(ops, [], 1)
    assert s["window_s"] == 110e-9
    assert s["busy_s"] == 45e-9
    assert 0.0 <= s["idle_share"] <= 1.0
    assert trace.measured(lead, None) == lead
    assert trace.summarize([], [], 1) is None


def test_streams_digest_is_bench_py_s():
    from cmix_tpu_torch.bench import _streams
    streams = [b"abc", b"", b"\x01\x02\x03\x04\x05"]
    out = np.full((3, 8), 7, dtype=np.uint8)
    lens = np.array([3, 0, 5], dtype=np.int64)
    for i, s in enumerate(streams):
        out[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
    want = hashlib.sha256(_streams(out, lens)[:, :5].tobytes()
                          + lens.astype("<i8").tobytes()).hexdigest()
    assert check.streams_sha256(streams) == want
