"""Benchmark: encode+decode throughput of the bench configuration on one card.

    python -m cmix_tpu_torch.bench [--device cuda|cpu]

The port's counterpart of the JAX package's ``bench.py``: the same corpus
(all 4 MiB of ``testdata/bench4m.raw``, 256 blocks of 16 KiB), the same
widths and speed-profile gates, the same three passes and the same one
JSON line on stdout ({"metric", "value", "unit", "vs_baseline"}).  The
passes go through one ``engine.make_transcoder``: on the card the byte
step is captured as a CUDA graph in the first pass, and the timed passes
replay it.

1. a first encode (the graph's warm-up and capture; the DMC kernel's
   build when its build directory is cold): "compile+first";
2. the timed encode, whose streams must equal the first encode's;
3. the timed decode of those streams, whose bytes must be the input.

``value`` is 2 x MiB / (encode s + decode s), host clock around each
``transcode`` (which returns numpy arrays, so each pass ends
synchronised).  The log lines, the Meter reports of the timed passes,
peak device memory and the card's name and power limit go to stderr.  A
failed check prints ``bench.py``'s zero line and exits 1.

The environment's model gates apply under the five bench gates (so
``PORT=1`` gives the portable profile), and ``bench.py``'s switches move
the config: BDMC_L, BPPM_CK, BPPM_DEEP, BBANK_CH, BCTX4 (gates), BDMC_N,
BLSTM_WIN (DMC pool, LSTM horizon).  The default device is the card;
without one it raises, as every entry point of the port does.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cmix_tpu_torch.engine import (
    MODE_DECODE, MODE_ENCODE, EngineConfig, init_perblock, init_shared,
    make_gates, make_transcoder, resolve_device)
from cmix_tpu_torch.models import dmc
from cmix_tpu_torch.runner import _split_blocks, env_gates
from cmix_tpu_torch.utils.profiling import Meter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "testdata", "bench4m.raw")
# reference cmix v21's combined encode+decode MB/s on one CPU thread
# (bench.py:122, work/baseline_measured.json)
BASELINE_MB_S = 0.000123
METRIC = "encode+decode MB/s/chip"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def corpus(mb=4):
    """The first ``mb`` MiB of ``testdata/bench4m.raw`` (4 MiB of mixed,
    non-repeated data; tools/make_bench_corpus.py).  A missing or short
    file raises: no other input is measured under its name."""
    with open(CORPUS, "rb") as f:
        data = f.read(mb << 20)
    if len(data) != mb << 20:
        raise ValueError(f"{CORPUS}: {len(data)} bytes, not {mb} MiB")
    return data


def bench_config(environ=os.environ):
    """(EngineConfig, gates) as ``bench.py:65-73`` builds them: the
    environment's gates (``runner.env_gates``) under the five bench gates,
    and the bench widths; the B* switches move both."""
    gates = dict(env_gates(environ),
                 DMC_LEVELS=int(environ.get("BDMC_L", 7)),
                 PPM_CK=int(environ.get("BPPM_CK", 0)),
                 PPM_DEEP=int(environ.get("BPPM_DEEP", 0)),
                 BANK_CH=int(environ.get("BBANK_CH", 1)),
                 CTX4=int(environ.get("BCTX4", 0)))
    cfg = EngineConfig(block_size=1 << 14, tbits=18, mbits=18, ibits=16,
                       lstm_hidden=256, seg_size=2048,
                       dmc_nodes=int(environ.get("BDMC_N", 16384)),
                       lstm_horizon=int(environ.get("BLSTM_WIN", 4)))
    return cfg, gates


def _streams(out, out_len):
    """The decode's input: each stream of ``out`` cut to its length."""
    keep = np.arange(out.shape[1])[None, :] < out_len[:, None]
    return np.where(keep, out, 0).astype(np.uint8)


def run(data, cfg, gates, device):
    """The three passes on ``data`` cut into ``cfg.block_size`` blocks, one
    coding group, through one transcoder.  -> a dict: each pass's seconds,
    ms a step and ``dmc_fused`` launches, the coded bytes and bpb, the
    checks (``roundtrip``, ``reencode_identical``, ``fits``: no stream
    past ``cfg.comp_size``; ``ok`` all three), each pass's Meter report,
    and the timed encode's ``streams`` (out, out_len)."""
    device = resolve_device(device)
    g = make_gates(gates)
    blocks = _split_blocks(data, cfg.block_size)
    b = blocks.shape[0]
    trans = make_transcoder(cfg, g, device)
    passes, meters = {}, {}

    def one_pass(label, inp, comp, mode):
        sh = init_shared(cfg, g, device)
        pb = init_perblock(cfg, g, b, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        meter = Meter()
        before = dmc.launch_counts()[0]
        t0 = time.perf_counter()
        hist, out, out_len = trans(sh, pb, inp, comp, mode, meter=meter)
        secs = time.perf_counter() - t0
        passes[label] = dict(s=secs, ms_per_step=secs / cfg.block_size * 1e3,
                             dmc_fused_launches=dmc.launch_counts()[0]
                             - before)
        meters[label] = meter
        return hist, out, out_len

    comp0 = np.zeros((b, cfg.comp_size), np.uint8)
    _, out_a, len_a = one_pass("first", blocks, comp0, MODE_ENCODE)
    log(f"encode compile+first: {passes['first']['s']:.1f}s")
    _, out, out_len = one_pass("encode", blocks, comp0, MODE_ENCODE)
    coded = int(out_len.sum())
    mib = len(data) / (1 << 20)
    bpb = 8.0 * coded / len(data)
    enc_s = passes["encode"]["s"]
    log(f"encode: {enc_s:.2f}s  {mib / enc_s:.3f} MB/s  bpb={bpb:.3f}")
    hist, _, _ = one_pass("decode", np.zeros_like(blocks),
                          _streams(out, out_len), MODE_DECODE)
    dec_s = passes["decode"]["s"]
    roundtrip = bool(np.array_equal(hist, blocks))
    log(f"decode: {dec_s:.2f}s  {mib / dec_s:.3f} MB/s  "
        f"roundtrip: {roundtrip}")
    identical = bool(np.array_equal(out, out_a)
                     and np.array_equal(out_len, len_a))
    fits = bool(np.all(out_len <= cfg.comp_size))
    for meter in meters.values():
        meter.out_bytes = coded
    return {
        "bytes": len(data), "blocks": b, "steps": cfg.block_size,
        "passes": passes, "coded_bytes": coded, "bpb": bpb,
        "roundtrip": roundtrip, "reencode_identical": identical,
        "fits": fits, "ok": roundtrip and identical and fits,
        "meters": {k: m.report({"mode": k}) for k, m in meters.items()},
        "streams": (out, out_len)}


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cmix_tpu_torch.bench",
        description="encode+decode throughput of the bench configuration "
                    "on 4 MiB of testdata/bench4m.raw")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (cpu only when asked)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    log(f"device: {torch.cuda.get_device_name(0) if cuda else 'cpu'} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    cfg, gates = bench_config()
    log(f"config: {cfg}, gates {gates}")
    data = corpus()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    r = run(data, cfg, gates, device)
    for label in ("encode", "decode"):
        log(f"meter {label}: {json.dumps(r['meters'][label])}")
    log(f"passes: {json.dumps(r['passes'])}")
    log(f"checks: roundtrip {r['roundtrip']}, re-encode identical "
        f"{r['reencode_identical']}, streams fit {r['fits']}")
    # the timed encode's streams and lengths, to compare runs and devices
    out, out_len = r["streams"]
    log("streams sha256: " + hashlib.sha256(
        _streams(out, out_len).tobytes()
        + out_len.astype("<i8").tobytes()).hexdigest())
    if cuda:
        log(f"peak device memory: {torch.cuda.max_memory_allocated(device)} "
            f"bytes")
        log(f"card: {card()}")
    if not r["ok"]:
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "MB/s",
                          "vs_baseline": 0.0}), flush=True)
        return 1
    mib = len(data) / (1 << 20)
    value = 2 * mib / (r["passes"]["encode"]["s"] + r["passes"]["decode"]["s"])
    print(json.dumps({
        "metric": f"{METRIC} ({mib:g}MB mixed corpus, bpb={r['bpb']:.3f}, "
                  "roundtrip ok; cmix anchor on the corpus' first 100KB: "
                  "0.688 bpb)",
        "value": round(value, 4),
        "unit": "MB/s",
        "vs_baseline": round(value / BASELINE_MB_S, 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
