"""Smoke test of the PyTorch/CUDA port (cmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package, needs one CUDA device and fails (non-zero exit, no result line)
without one.  Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``cmix_tpu_torch/csrc`` (nvcc, sm_90a), one
   nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card, bit-exact,
   with CUDA-event times, at B=256 blocks, N=16384 nodes, L=8 and L=7
   levels, from DMC states after real ``plan_step``s on
   ``testdata/bench4m.raw``: the apply+walk (``dmc_fused``, with the
   pending descriptors) and the prediction-only walk (``dmc_counts``, on
   the tables with the descriptors applied);
4. the fast profile's main path: ``runner.compress`` then
   ``runner.decompress`` at the CLI widths and default gates on a text
   prefix of ``testdata/text100k.raw`` (size and block size cut, printed),
   exact round trip, launch counts > 0 in both directions, a second encode
   byte-identical, and a small-width input coded on the CPU too (archive
   sizes must agree within 2%);
5. the portable profile (PORT=1) across devices: the JAX package's
   committed archive ``testdata/portable.tcmx`` decodes exactly on the
   card, and the card's and the CPU's encodes of its input are both
   byte-identical to it; the card's archive decodes exactly on the CPU;
6. the portable profile at the CLI widths on a text prefix: exact round
   trip, identical re-encode, launch counts > 0 both ways, and the archive
   byte-identical to the JAX package's CPU archive (by its sha256);
7. ms per byte step: the bench speed profile at B=256 and bench widths,
   and the default and portable profiles at B=16 and B=256, CLI widths;
8. a ``kernels:`` summary, the JSON kernel line, the card line, and last the
   contract line ``{"ok": true, "device": {...}}``.

Each coding path (4-6) is driven with the kernels' launch counts set to 0
just before it and read just after; the JSON line sums them.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # H100 SXM, outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))
# fast main path: 8 KiB of text in 512-byte blocks (one group of 16 lanes,
# 512 byte steps per direction); the step count is the block size
MAIN_KIB, MAIN_BLOCK = 8, 512
SMALL_BLOCK = 256               # the CPU-vs-card size check, 1 KiB
BENCH_WARM, BENCH_STEPS = 8, 32
STEP_WARM, STEP_STEPS = 4, 16
# the portable fixture: the JAX package's PORT=1 archive of PORT_FIXTURE,
# made on the CPU at these small widths in one coding group
# (tests/test_torch_port_fixture.py regenerates it and holds it equal)
PORT_FIXTURE = os.path.join(ROOT, "testdata", "portable.raw")
PORT_ARCHIVE = os.path.join(ROOT, "testdata", "portable.tcmx")
PORT_SMALL = dict(block_size=256, seg_size=256, tbits=12, mbits=12,
                  ibits=10, pbits=12, lstm_hidden=32, lstm_horizon=4,
                  dmc_nodes=4096)
PORT_BATCH = 8
# the portable profile at CLI widths: 4 KiB in 256-byte blocks; the sha256
# of the JAX package's PORT=1 archive of it on the CPU
# (tests/test_torch_port_cli_width.py recomputes it)
PORT_KIB, PORT_BLOCK = 4, 256
PORT_CLI_SHA256 = ("56d2fd5475af293c66b00d6a1bd74595"
                   "34730f8e5cf755e5628a0ec7dbaad998")
# the runner CLI's widths (tbits 18, LSTM 256, horizon auto = 4 under 256
# KiB, 16384 DMC nodes; mbits 20, ibits 16, pbits 20 and 2 LSTM layers are
# the EngineConfig defaults)
CLI_WIDTHS = dict(tbits=18, lstm_hidden=256, lstm_horizon=4,
                  dmc_nodes=16384)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def _events_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _cli_cfg(block):
    from cmix_tpu_torch.engine import EngineConfig
    return EngineConfig(block_size=block, **CLI_WIDTHS)


def _text(kib):
    with open(os.path.join(ROOT, "testdata", "text100k.raw"), "rb") as f:
        return f.read()[:kib << 10]


class Launches:
    """The kernels' launch counts over one coding path: set to 0 on
    entry, read on exit."""

    def __enter__(self):
        from cmix_tpu_torch.models import dmc
        self.fns = {"dmc_fused": dmc.fused_apply_walk,
                    "dmc_counts": dmc.counts_walk}
        for fn in self.fns.values():
            fn.launches = 0
        return self

    def __exit__(self, *exc):
        self.counts = {k: fn.launches for k, fn in self.fns.items()}


def build_kernels():
    """Compile every csrc/*.cu at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor
    from cmix_tpu_torch import build
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))

    def one(name):
        t0 = time.time()
        _, log = build.compile_source(name, verbose=True)
        return name, time.time() - t0, log

    with ThreadPoolExecutor(len(names)) as ex:
        res = list(ex.map(one, names))
    for name, sec, log in res:
        print(f"build: {name}.cu {sec:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")


def dmc_descriptors(B, N, levels, n_steps, device):
    """DMC state after ``n_steps`` real byte updates on bench4m.raw lanes,
    with the last step's pending descriptors not yet applied (the plain
    version throughout, so the kernel is not its own reference)."""
    import numpy as np
    import torch
    from cmix_tpu_torch.models import dmc
    raw = np.fromfile(os.path.join(ROOT, "testdata", "bench4m.raw"),
                      dtype=np.uint8)
    lanes = raw[:B * (len(raw) // B)].reshape(B, -1)[:, :n_steps]
    data = torch.as_tensor(lanes.astype(np.int64), device=device)
    pb = dmc.init_dmc_perblock(N, B, device)
    for t in range(n_steps):
        dmc._apply_plain(pb["dmc_nxt"], pb["dmc_cnt"],
                         *(pb[k] for k in dmc.DMC_UPD_KEYS))
        cw, vis, wn = dmc._walk_plain(pb["dmc_nxt"], pb["dmc_cnt"],
                                      pb["dmc_cur"], levels)
        pb.update(dmc.plan_step(pb, {"cw": cw, "vis": vis, "wn": wn},
                                data[:, t], levels))
    return pb


def _compare(name, levels, pairs):
    import torch
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name} L={levels}: kernel != plain "
                             f"(max abs err {err})")
    return err


def _bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def check_dmc_kernels(device, B=256, N=16384, n_steps=50):
    """Both DMC kernels vs their plain versions -> {name: {levels: res}}."""
    from cmix_tpu_torch.models import dmc
    out = {"dmc_fused": {}, "dmc_counts": {}}
    for levels in (8, 7):
        pb = dmc_descriptors(B, N, levels, n_steps, device)
        args = [pb["dmc_cur"]] + [pb[k] for k in dmc.DMC_UPD_KEYS]
        nk, ck = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
        npl, cpl = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
        got = dmc.fused_apply_walk(nk, ck, *args, levels)
        dmc._apply_plain(npl, cpl, *args[1:])
        want = dmc._walk_plain(npl, cpl, args[0], levels)
        err = _compare("dmc_fused", levels,
                       [(nk, npl), (ck, cpl)] + list(zip(got, want)))
        # re-applying the same set-writes is idempotent: time repeats
        ms = _events_ms(lambda: dmc.fused_apply_walk(nk, ck, *args, levels),
                        200)
        plain_ms = _events_ms(lambda: (
            dmc._apply_plain(npl, cpl, *args[1:]),
            dmc._walk_plain(npl, cpl, args[0], levels)), 20)
        # least traffic: descriptors + cur read, the visited pointer and
        # count words read, the valid descriptor words written, the three
        # outputs written (4 bytes each)
        n_desc = sum(int(pb[k].numel()) for k in dmc.DMC_UPD_KEYS)
        n_valid = sum(int((pb[k] >= 0).sum())
                      for k in ("dmc_uX", "dmc_uS", "dmc_uU"))
        walked = (2 ** (levels - 1) - 1) + 2 ** levels
        outs = 2 ** levels * 2 + 2 ** (levels - 1)
        nbytes = 4 * (B + n_desc + n_valid + B * (walked + outs))
        out["dmc_fused"][levels] = dict(
            err=err, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            bound_ms=_bound_ms(nbytes, B * (walked + outs)))

        # the prediction-only walk reads the applied tables (npl, cpl)
        cur = args[0]
        got = dmc.counts_walk(npl, cpl, cur, levels)
        err = _compare("dmc_counts", levels,
                       [(got, dmc._counts_plain(npl, cpl, cur, levels))])
        ms = _events_ms(lambda: dmc.counts_walk(npl, cpl, cur, levels), 200)
        plain_ms = _events_ms(
            lambda: dmc._counts_plain(npl, cpl, cur, levels), 20)
        # least traffic: cur read, the visited pointer and count words
        # read, the (B, 256) output written (4 bytes each)
        nbytes = 4 * (B + B * (walked + 256))
        out["dmc_counts"][levels] = dict(
            err=err, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            bound_ms=_bound_ms(nbytes, B * walked))
        for name in out:
            r = out[name][levels]
            print(f"{name} L={levels} B={B} N={N}: exact, kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.6f} ms ({r['nbytes']} B moved)")
    return out


def _round_trip(label, data, cfg, device, **kw):
    """compress, decompress, compress again on ``device``: exact round trip,
    identical re-encode, DMC kernel launches > 0 each way.  Returns the
    launch windows and the archive."""
    import numpy as np
    from cmix_tpu_torch import runner
    with Launches() as enc:
        t0 = time.time()
        arc = runner.compress(data, cfg, device=device, **kw)
        t_enc = time.time() - t0
    with Launches() as dec:
        t0 = time.time()
        back = runner.decompress(arc, device=device)
        t_dec = time.time() - t0
    if back != data:
        raise AssertionError(f"{label}: round trip is not exact")
    e, d = enc.counts["dmc_fused"], dec.counts["dmc_fused"]
    if e <= 0 or d <= 0:
        raise AssertionError(f"{label}: dmc_fused launches enc={e} dec={d}:"
                             " not on the path")
    with Launches() as enc2:
        again = runner.compress(data, cfg, device=device, **kw)
    if again != arc:
        raise AssertionError(f"{label}: two encodes differ")
    bpb = 8.0 * len(arc) / len(data)
    if not np.isfinite(bpb) or bpb >= 8.0:
        raise AssertionError(f"{label}: bpb {bpb} is not a compression")
    mb = len(data) / 1e6
    print(f"{label}: exact round trip, identical re-encode, {len(arc)} B "
          f"archive, {bpb:.4f} bpb; encode {t_enc:.2f} s "
          f"({mb / t_enc:.6f} MB/s), decode {t_dec:.2f} s "
          f"({mb / t_dec:.6f} MB/s), combined {2 * mb / (t_enc + t_dec):.6f}"
          f" MB/s; dmc_fused launches enc={e} dec={d} re-encode="
          f"{enc2.counts['dmc_fused']}")
    return [enc, dec, enc2], arc


def main_path(device):
    """The fast profile through the runner at CLI widths."""
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.engine import EngineConfig
    data = _text(MAIN_KIB)
    print(f"main path: {len(data)} bytes of text100k.raw, block size cut "
          f"65536 -> {MAIN_BLOCK} ({len(data) // MAIN_BLOCK} blocks in one "
          "group), CLI widths, default gates")
    windows, _ = _round_trip("main path", data, _cli_cfg(MAIN_BLOCK),
                             device)

    # the same model on the CPU (the path the tests hold against the JAX
    # package) and on the card, at small widths: sizes agree within 2%
    small = EngineConfig(block_size=SMALL_BLOCK, seg_size=SMALL_BLOCK,
                         tbits=12, mbits=12, ibits=10, pbits=12,
                         lstm_hidden=32, lstm_horizon=4, dmc_nodes=4096)
    part = data[:1024]
    with Launches() as w:
        a_gpu = runner.compress(part, small, max_batch=8, device=device)
        ok = runner.decompress(a_gpu, device=device) == part
    a_cpu = runner.compress(part, small, max_batch=8, device="cpu")
    gap = (len(a_gpu) - len(a_cpu)) / len(a_cpu)
    if not ok or abs(gap) > 0.02:
        raise AssertionError(f"small widths: gpu {len(a_gpu)} B vs cpu "
                             f"{len(a_cpu)} B ({gap:+.4%}), round trip {ok}")
    print(f"small widths ({len(part)} B, {SMALL_BLOCK} B blocks): gpu "
          f"archive {len(a_gpu)} B, cpu {len(a_cpu)} B ({gap:+.4%}), gpu "
          "round trip exact")
    return windows + [w]


def portable_cross_device(device):
    """The JAX package's PORT=1 archive against the port on the card and
    on the CPU: decodes exactly, re-encodes byte-identically."""
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.engine import EngineConfig
    with open(PORT_FIXTURE, "rb") as f:
        data = f.read()
    with open(PORT_ARCHIVE, "rb") as f:
        ref = f.read()
    cfg = EngineConfig(**PORT_SMALL)
    kw = dict(max_batch=PORT_BATCH, gates={"PORT": 1})
    print(f"portable fixture: {len(data)} B of text, the JAX package's "
          f"PORT=1 archive {len(ref)} B ({cfg.block_size} B blocks, one "
          f"group of {-(-len(data) // cfg.block_size)}, small widths)")
    legs, windows = [], []
    for what, fn, dev in (
            ("card decodes the JAX archive", lambda: runner.decompress(
                ref, device=device), device),
            ("card encodes", lambda: runner.compress(
                data, cfg, device=device, **kw), device),
            ("CPU encodes", lambda: runner.compress(
                data, cfg, device="cpu", **kw), "cpu")):
        with Launches() as w:
            t0 = time.time()
            out = fn()
            legs.append((what, out, time.time() - t0))
        if dev != "cpu":
            windows.append(w)
            if w.counts["dmc_fused"] <= 0:
                raise AssertionError(f"portable: {what}: no dmc_fused launch")
    t0 = time.time()
    back_cpu = runner.decompress(legs[1][1], device="cpu")
    legs.append(("CPU decodes the card's archive", back_cpu,
                 time.time() - t0))
    for (what, out, sec), want in zip(legs, (data, ref, ref, data)):
        if out != want:
            raise AssertionError(f"portable: {what}: not exact "
                                 f"({len(out)} B vs {len(want)} B)")
        print(f"portable: {what}: exact ({len(out)} B, {sec:.2f} s)")
    return windows


def portable_cli(device):
    """The portable profile through the runner at CLI widths."""
    data = _text(PORT_KIB)
    print(f"portable path: {len(data)} bytes of text100k.raw, block size "
          f"cut 65536 -> {PORT_BLOCK} ({len(data) // PORT_BLOCK} blocks in "
          "one group), CLI widths, PORT=1")
    windows, arc = _round_trip("portable path", data, _cli_cfg(PORT_BLOCK),
                               device, gates={"PORT": 1})
    digest = hashlib.sha256(arc).hexdigest()
    if digest != PORT_CLI_SHA256:
        raise AssertionError(f"portable path: archive sha256 {digest} is not"
                             f" the JAX package's {PORT_CLI_SHA256}")
    print("portable path: the card's archive is byte-identical to the JAX "
          f"package's CPU archive (sha256 {digest[:16]}...)")
    return windows


def step_ms(device, label, env, cfg, B, warm, steps):
    """Host-clock ms per byte step (synchronized) over ``steps`` steps on
    bench4m.raw lanes after ``warm`` warm-up steps."""
    import numpy as np
    import torch
    from cmix_tpu_torch import engine as E
    g = E.make_gates(env)
    raw = np.fromfile(os.path.join(ROOT, "testdata", "bench4m.raw"),
                      dtype=np.uint8).reshape(256, -1)[:B]
    inp = torch.as_tensor(raw[:, :warm + steps].T.copy(), device=device)
    sh = E.init_shared(cfg, g, device)
    pb = E.init_perblock(cfg, g, B, device)
    cd = E.init_coder(B, device)
    comp = torch.zeros((B, cfg.comp_size), dtype=torch.uint8, device=device)
    mode = torch.zeros(B, dtype=torch.int64, device=device)
    step = E.make_byte_step(cfg, g, device)
    with torch.no_grad():
        for t in range(warm):
            sh, pb, cd, _, _ = step(sh, pb, cd, comp, inp[t], t, mode)
        torch.cuda.synchronize()
        t0 = time.time()
        for t in range(warm, warm + steps):
            sh, pb, cd, _, _ = step(sh, pb, cd, comp, inp[t], t, mode)
        torch.cuda.synchronize()
    ms = (time.time() - t0) / steps * 1e3
    print(f"step: {label}, B={B}: {ms:.3f} ms per byte step over {steps} "
          f"steps after {warm} warm-up -> {B / ms * 1e3 / 1e6:.6f} MB/s "
          "one direction")
    return ms


def step_times(device):
    from cmix_tpu_torch import engine as E
    bench = E.EngineConfig(block_size=16384, tbits=18, mbits=18, ibits=16,
                           lstm_hidden=256, seg_size=2048, dmc_nodes=16384,
                           lstm_horizon=4)
    step_ms(device, "bench profile (bench widths and gates)",
            E.BENCH_GATES, bench, 256, BENCH_WARM, BENCH_STEPS)
    cli = _cli_cfg(16384)
    for label, env in (("fast profile, default gates", {}),
                       ("portable profile, PORT=1", {"PORT": 1})):
        for B in (16, 256):
            step_ms(device, f"{label}, CLI widths", env, cli, B, STEP_WARM,
                    STEP_STEPS)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from cmix_tpu_torch.engine import resolve_device
    device = resolve_device("cuda")
    t_all = time.time()
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_kernels()
    res = check_dmc_kernels(device)
    windows = main_path(device)
    windows += portable_cross_device(device)
    windows += portable_cli(device)
    step_times(device)
    replaces = {"dmc_fused": "cmix_tpu/models/dmc.py:153",
                "dmc_counts": "cmix_tpu/models/dmc.py:287"}
    kernels = []
    for name, per_level in res.items():
        r = per_level[8]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cmix_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(w.counts[name] for w in windows),
            "max_abs_err": max(v["err"] for v in per_level.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    summary = ", ".join(f"{k['name']} launches={k['launches']}"
                        for k in kernels)
    print(f"kernels: {summary} over the coding paths; both exact at L=8 and "
          f"L=7 (max_abs_err 0); dmc_counts is on no path of the system, as "
          f"its TPU original; {time.time() - t_all:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
