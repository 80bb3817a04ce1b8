"""Smoke test of the PyTorch/CUDA port (cmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package, needs one CUDA device and fails (non-zero exit, no result line)
without one.  Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``cmix_tpu_torch/csrc`` (nvcc, sm_90a, with
   ``-Xptxas -v``: registers, shared memory, spills), one nvcc per source,
   all started together;
3. each kernel against its plain PyTorch version on the card, bit-exact,
   at B=256 blocks, N=16384 nodes and every walk depth L in 1..8, on DMC
   states after real ``plan_step``s on ``testdata/bench4m.raw`` and on the
   edge-case descriptor sets of ``dmc_edge_cases``: the apply+walk
   (``dmc_fused``, with the pending descriptors) and the prediction-only
   walk (``dmc_counts``, on the tables with the descriptors applied).
   Then device times at every L (``_device_ms``: a device sleep covers the
   host's enqueue, so the events time the device; tables cold and warm),
   the wrappers' host µs per call, the per-level slope and the chain
   floor (L+1 levels at that slope); then both kernels at the larger pools
   N=32768 and N=65536 (L=8), checked and timed the same way;
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
7. the content-routed path on ``testdata/routed.raw`` (x86 code, a 24-bit
   BMP, a WAV and a baseline JPEG: the E8/E9, color and JPEG transforms,
   the segment table and the routed gates X86X=2, GRID2=1, LMS=2, JPEGX=1):
   the fast profile at CLI widths (exact round trip, identical re-encode,
   launches > 0 both ways, the routed gates in the archive's gate record)
   and at small widths against the CPU's archive (sizes within 1%); the
   JAX package's PORT=1 archive ``testdata/routed.tcmx`` decoded and
   re-encoded byte-identically on the card and on the CPU; and the
   portable profile at CLI widths, its archive held to the JAX package's
   sha256; then under CMIX_JPEGC=0 (the JPEG a pass-through segment, no
   JPEGX): the JAX package's PORT=1 archive ``testdata/routed_nojpegc.tcmx``
   decoded and re-encoded byte-identically on the card and on the CPU, and
   the fast profile at CLI widths (gate record X86X=2;LMS=2;GRID2=1);
8. the gated path on ``testdata/gated.raw`` (the routed fixture and ~1 KiB
   of text with table rows) under every off-by-default mechanism the port
   runs (``utils/profiling.GATED``: SSE2, APM3X, MIX_DYN4, MIX_KIND,
   MIX_AUX, SBANK_ADAPT, VMATCH, APM_FIXED, MIX_TAU, MIX_BOOST) with JVAL=2
   routed by JVAL_ROUTE: the fast profile at CLI widths (exact round trip,
   identical re-encode, launches > 0 both ways, every gate in the gate
   record) and at small widths against the CPU's archive (sizes within
   1%); the JAX package's PORT=1 archive ``testdata/gated.tcmx`` (of
   ``GATED_PORT``, the mechanisms the portable profile allows) decoded and
   re-encoded byte-identically on the card; the portable profile at CLI
   widths, its archive held to the JAX package's sha256;
9. the gates path on the gated fixture under the remaining gate values, two
   sets of ``utils/profiling.py``: LEAN (the default-on components off
   together) and KNOBS (the value knobs moved together, DMC_LEVELS=4 among
   them): per set the fast profile at CLI widths (exact round trip,
   identical re-encode, launches > 0 both ways, the set in the gate record)
   and at small widths against the CPU's archive (sizes within 0.1%), the
   portable profile at CLI widths held to the JAX package's sha256; for
   KNOBS the JAX package's PORT=1 archive ``testdata/knobs.tcmx`` decoded
   and re-encoded byte-identically on the card;
10. ``--resume`` on the card: a compress interrupted after its first coding
    group (the journal saver raises), then resumed: it codes only the other
    groups, writes the uninterrupted archive and removes the journal; a
    fast-profile journal the CPU wrote is ignored on the card (every group
    coded again, the same archive);
11. dictionary mode (``--dict``: the WRT text transform, WRTW=1 routed, the
   shared state pretrained on the dictionary at B=1 and cached) with
   ``testdata/mini.dic`` (english.dic's first 128 lines) on a text prefix,
   in a fresh pretraining cache: the fast profile at CLI widths (the encode
   pretrains, its replay's seconds, ms per step and launches printed; the
   decode and a re-encode load the cache; exact round trip, identical
   re-encode, flags 3 and WRTW=1 in the gate record), then the portable
   profile at CLI widths with an empty cache, its archive held to the JAX
   package's sha256 and decoded exactly;
12. the sharded transcoder (``cmix_tpu_torch.parallel``: dp x tp on
    torch.distributed, ranks spawned as processes that share the card, each
    running the eager byte step): the dry run on 4 Gloo ranks (dp=2, tp=2,
    the JAX package's dry-run config, exact round trip), whose ranks then
    code 4 lanes of 128-byte text blocks at CLI widths on the same dp=2 x
    tp=2 mesh (one start of the ranks: PORT=1 byte-identical to the
    unsharded card archive; the fast profile's round trip exact on the
    mesh, within 1% of the unsharded size), then one NCCL rank (PORT=1,
    the unsharded archive); every replica of the
    shared state equal across ranks; each leg's ms per step, collective
    bytes per step, seconds and ``dmc_fused`` launches;
13. ms per byte step as the transcoder runs it (one segment after one of
    warm-up), through the captured graph and through the eager step: the
    bench speed profile at B=256 and B=1 and bench widths, and the default
    and portable profiles at B=16 and B=256, CLI widths; then through the
    graph at B=256 and CLI widths with and without the gated path's
    mechanisms, each profile, and under LEAN and KNOBS: wall, device busy,
    idle share and kernels per step (``utils/profiling.py``);
14. the graph (``engine.make_segment_fn``: one byte step captured as a
    CUDA graph and replayed, the default on the card, so phases 4-11 ran
    through it): the main path's archives of phases 4 and 6 (fast and
    portable, CLI widths) and the gates path's fast archives of both sets
    (phase 9) against the eager step's, byte-identical (the portable one
    thus still the JAX package's); a dictionary replay at B=1
    through the graph and the eager step in both profiles, the states
    equal (integer leaves exact, floats within 2e-5); wall ms (untraced
    and traced), device busy ms and idle share per step, graph and eager,
    at bench widths and gates, B=256 and B=1 (``utils/profiling.py``);
    and the port's bench (``cmix_tpu_torch/bench.py`` ``run``) on one
    segment (2048 steps x 256 lanes of bench4m.raw): a first encode, the
    timed encode (its streams equal to the first's) and the timed decode
    (exact) through one ``engine.make_transcoder`` with a Meter each,
    2048 ``dmc_fused`` launches a pass, the reports and the run printed;
15. a ``kernels:`` summary, the JSON kernel line, the card line, and last
    the contract line ``{"ok": true, "device": {...}}``.

Each coding path (4-12, 14) is driven with the kernels' launch counts set
to 0 just before it and read just after (the sharded phase's ranks each
around each of their transcodes); a graph's replays count the launches
its capture recorded (the warm-up's launches, on copies of the state, and
the capture's host calls are not counted).  The JSON line sums them (and
gives the routed path's, its CMIX_JPEGC=0 legs', the gated path's, the
gates path's, of them at walk depths 8 and 4, the dictionary path's, its
pretraining's and the sharded phase's sums on their own).  Every phase
prints its seconds.
"""

import hashlib
import json
import os
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # H100 SXM, outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))
# The coding paths' time is their byte steps (as many as the block has
# bytes; a captured graph's replay on the card), the dictionary's replay
# (one step per byte at B=1), the CPU legs' payload bytes and the graph
# phase's eager yardsticks (0.1-0.2 s a step on an H100 whatever the lane
# count).  The blocks were cut from 512 and 256 to 128 bytes when the
# routed path joined, and the routed path's fast profile from 512 to 256
# when the dictionary path joined, while every step was eager.
# fast main path: 4 KiB of text in 128-byte blocks (one group of 32 lanes)
MAIN_KIB, MAIN_BLOCK = 4, 128
SMALL_BLOCK = 128               # the CPU-vs-card size check, 1 KiB
BENCH_STEPS = 32
# the DMC kernels: checked and timed at every walk depth; device times over
# REPS launches, with COLD copies of the tables cycled (4 GiB at B=256,
# N=16384, 16 GiB at N=65536; a launch reads ~1 MB of a young machine's
# rows, so a copy's rows leave the 50 MB L2 of an H100 before it comes
# round again)
LEVELS = range(1, 9)
REPS, COLD = 200, 128
LARGE_POOLS = (32768, 65536)
STEP_STEPS = 8
# the graph phase: the bench-width segment (the block cut to one segment
# of bench.py's 2048 steps), steps per profiled segment, and the bytes of
# the dictionary that the graph-vs-eager replays replay (cut from all 600
# B, 640 steps, to 256 steps when the gated path joined: the eager step
# ran at 0.08-0.13 s a step there)
BENCH_SEG = 2048
PROFILE_STEPS = 8
DICT_EAGER_BYTES = 128
# the portable fixture: the JAX package's PORT=1 archive of PORT_FIXTURE,
# made on the CPU at these small widths in one coding group
# (tests/test_torch_port_fixture.py regenerates it and holds it equal)
PORT_FIXTURE = os.path.join(ROOT, "testdata", "portable.raw")
PORT_ARCHIVE = os.path.join(ROOT, "testdata", "portable.tcmx")
PORT_SMALL = dict(block_size=256, seg_size=256, tbits=12, mbits=12,
                  ibits=10, pbits=12, lstm_hidden=32, lstm_horizon=4,
                  dmc_nodes=4096)
PORT_BATCH = 8
# the routed fixture (tests/torch_parity.py --write-routed-fixture): x86
# code, a 24-bit BMP, a WAV and a baseline JPEG; the JAX package's PORT=1
# archive of it at ROUTED_SMALL's widths in one group of ROUTED_BATCH
# (tests/test_torch_routed_fixture.py regenerates the archive)
ROUTED_FIXTURE = os.path.join(ROOT, "testdata", "routed.raw")
ROUTED_ARCHIVE = os.path.join(ROOT, "testdata", "routed.tcmx")
ROUTED_SMALL = dict(PORT_SMALL, block_size=128, seg_size=128)
ROUTED_BATCH = 64
# the same under CMIX_JPEGC=0, the JPEG kept as a pass-through segment
# (tests/torch_parity.py --write-routed-nojpegc-fixture writes it,
# tests/test_torch_jpegc_runner.py holds both packages to it)
ROUTED_NOJPEGC_ARCHIVE = os.path.join(ROOT, "testdata", "routed_nojpegc.tcmx")
# the routed fixture at CLI widths: the fast profile in 256-byte blocks;
# the portable profile in 128-byte blocks, held to the sha256 of the JAX
# package's PORT=1 archive on the CPU (tests/test_torch_routed_cli_width.py
# recomputes it)
ROUTED_BLOCK, ROUTED_PORT_BLOCK = 256, 128
ROUTED_PORT_SHA256 = ("6ff52d6050f4c66dbb7380b909123bed"
                      "86d991e6ce8161cda1b14df254833d36")
# the portable profile at CLI widths: 4 KiB in 128-byte blocks; the sha256
# of the JAX package's PORT=1 archive of it on the CPU
# (tests/test_torch_port_cli_width.py recomputes it)
PORT_KIB, PORT_BLOCK = 4, 128
PORT_CLI_SHA256 = ("dba946f7b1ca74cb7a76ece85a61d81f"
                   "b478bbf5550ec23a16a2dc5a4a22e35f")
# the dictionary path: english.dic's first 128 lines (600 B; replayed with
# LF -> space, padded to 640 steps at 128-byte blocks) on 2 KiB of text
# (1744 B of WRT payload, 14 blocks in one group) at CLI widths; the sha256
# of the JAX package's PORT=1 archive of it on the CPU
# (tests/test_torch_dict_cli_width.py recomputes it)
DICT_FILE = os.path.join(ROOT, "testdata", "mini.dic")
DICT_KIB, DICT_BLOCK = 2, 128
DICT_PORT_SHA256 = ("aff0d39ba4c1426e61ea2715cc91176c"
                    "83863427c7ebcc77749542b08d2d0027")
# the gated path: the routed fixture and ~1 KiB of text with table rows
# (tests/torch_parity.py --write-gated-fixture) under every off-by-default
# mechanism the port runs (utils/profiling.GATED), JVAL=2 routed with JPEGX
# by JVAL_ROUTE; the fast profile at CLI widths in GATED_BLOCK-byte blocks
# and at small widths against the CPU; the JAX package's PORT=1 archive of
# it (the mechanisms the portable profile allows, GATED_PORT) at small
# widths in one group (tests/test_torch_gated_fixture.py regenerates it);
# the portable profile at CLI widths in GATED_PORT_BLOCK-byte blocks, held
# to the sha256 of the JAX package's CPU archive
# (tests/test_torch_gated_cli_width.py recomputes it)
GATED_FIXTURE = os.path.join(ROOT, "testdata", "gated.raw")
GATED_ARCHIVE = os.path.join(ROOT, "testdata", "gated.tcmx")
GATED_SMALL = ROUTED_SMALL
GATED_BATCH = 64
GATED_BLOCK, GATED_PORT_BLOCK = 256, 128
JVAL_ROUTE = "2"
GATED_PORT_SHA256 = ("5ec5a09a06d08629bbbf10c291b41ccc"
                     "c85d1a58a403ae00b4fabbe7bc936a43")
# the gates path (the remaining gate values, utils/profiling.LEAN and
# KNOBS) on the gated fixture: the fast profile at CLI widths in
# GATES_BLOCK-byte blocks (one group) and at the gated path's small widths
# against the CPU (sizes within GATES_SIZE_TOL); the JAX package's PORT=1
# archive of it under KNOBS at the gated path's small widths
# (tests/test_torch_gates_fixture.py regenerates it); the portable profile
# at CLI widths, held to the sha256 of the JAX package's CPU archive of each
# set (tests/test_torch_gates_cli_width*.py recompute them)
GATES_BLOCK = 128
GATES_SIZE_TOL = 0.001
KNOBS_ARCHIVE = os.path.join(ROOT, "testdata", "knobs.tcmx")
GATES_PORT_SHA256 = {
    "lean": ("b1dd53a793ac36ad807b1e8def8182c8"
             "186d5253a7566815dbc3cd027856c7e6"),
    "knobs": ("1bace65c275ff7ddf985903897505217"
              "b6b2d94a1f36dd7b3d2e4918a1dcfa0a")}
# the resume leg: a text prefix at the main path's small widths in groups
# of RESUME_BATCH blocks
RESUME_KIB, RESUME_BATCH = 2, 4
# the sharded phase: SHARD_LANES lanes of SHARD_BLOCK-byte text blocks at
# CLI widths on the dry run's 2 x 2 mesh of ranks sharing the card under
# Gloo (the fast profile's archive within SHARD_SIZE_TOL of the unsharded
# one's), then one NCCL rank through the graph
SHARD_LANES, SHARD_BLOCK = 4, 128
SHARD_SIZE_TOL = 0.01
# the runner CLI's widths (tbits 18, LSTM 256, horizon auto = 4 under 256
# KiB, 16384 DMC nodes; mbits 20, ibits 16, pbits 20 and 2 LSTM layers are
# the EngineConfig defaults)
CLI_WIDTHS = dict(tbits=18, lstm_hidden=256, lstm_horizon=4,
                  dmc_nodes=16384)


def _events_ms(fn, reps):
    """ms per call of ``fn`` between two events around ``reps`` calls: the
    caller's cost, host enqueue included (the plain versions' time)."""
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


def _device_ms(fns, reps):
    """Device ms per launch of a kernel wrapper, which the host's enqueue
    rate cannot bound: a device sleep (``torch.cuda._sleep``) is queued
    first, long enough to cover the host's enqueue of all ``reps`` calls
    (``fns[i % len(fns)]``), so the launches run back to back after it and
    the events around them time the device.  Raises unless the event
    after the sleep was still pending when the host had queued the last
    call.  -> dict(ms, host_us per call, sleep_ms, enqueue_ms)."""
    import torch
    fns[0]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fns[i % len(fns)]()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    for _ in range(3):
        # cycles at <= 2 GHz (the H100's clock is below): >= 2x the enqueue
        s0.record()
        torch.cuda._sleep(int(4e9 * enqueue) + 2_000_000)
        a.record()
        t0 = time.perf_counter()
        for i in range(reps):
            fns[i % len(fns)]()
        enqueue = time.perf_counter() - t0
        covered = not a.query()     # the device was still in the sleep
        b.record()
        torch.cuda.synchronize()
        slept = s0.elapsed_time(a)
        if covered:
            return dict(ms=a.elapsed_time(b) / reps,
                        host_us=enqueue / reps * 1e6, sleep_ms=slept,
                        enqueue_ms=enqueue * 1e3)
    raise RuntimeError(f"device timing: the device sleep ({slept:.3f} ms) "
                       f"ended before the host had queued its {reps} calls "
                       f"({enqueue * 1e3:.3f} ms)")


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


EDGE_CASES = ("none", "ux_dups", "clone_and_path", "on_path", "leaf_count",
              "ids_0_and_last", "twins")
# dmc_fused forwards its pending words through tables indexed by state id
# in pools of up to TABLED_NODES states, and by comparing with every
# descriptor in larger ones (csrc/dmc_fused.cu, kMaxTabled)
TABLED_NODES = 16384


def dmc_edge_cases(pb, levels, seed=0):
    """Descriptor sets that real ``plan_step``s rarely produce, made from
    ``seed`` on the tables and ``cur`` of the DMC state ``pb`` ->
    {name: state}; each state shares pb's tables (clone before applying)
    and has its own cur and six descriptor tensors.  As ``plan_step``
    guarantees, every pointer word's child ids are < N and duplicate
    indices inside a group carry identical words.

    * ``none``: every descriptor -1;
    * ``ux_dups``: all 24 count descriptors valid, 12 nodes twice each;
    * ``clone_and_path``: a clone word and a path word on the same walked
      node, with different words (the path word wins);
    * ``on_path``: writes on cur and on a node of every walk level, so
      that the written words change the path the walk takes;
    * ``leaf_count``: count writes on nodes of the walk's last level;
    * ``ids_0_and_last``: cur = N-1, and writes on nodes 0 and N-1 whose
      words point at 0 and N-1;
    * ``twins``: writes on walked nodes and on their twins, the nodes
      TABLED_NODES further on (mod N), in every group, with a path word
      on a node that has a clone word too (for N > TABLED_NODES, twins
      agree in the low bits a table of TABLED_NODES entries would index)."""
    import numpy as np
    import torch
    from cmix_tpu_torch.models import dmc
    B, N = pb["dmc_nxt"].shape
    vis = dmc._walk_plain(pb["dmc_nxt"], pb["dmc_cnt"], pb["dmc_cur"],
                          levels)[1].cpu().numpy()
    rng = np.random.default_rng(seed)

    def ptr_words(*shape):
        return (rng.integers(0, N, shape)
                | (rng.integers(0, N, shape) << 16))

    def cnt_words(*shape):
        return rng.integers(0, 1 << 32, shape)

    def on_level(lev, count):
        """(B, count) random walked nodes of byte-tree level ``lev``."""
        lo = 1 << lev
        return vis[np.arange(B)[:, None],
                   lo + rng.integers(0, lo, (B, count))]

    def state(cur=None, **desc):
        out = {"dmc_nxt": pb["dmc_nxt"], "dmc_cnt": pb["dmc_cnt"],
               "dmc_cur": pb["dmc_cur"] if cur is None else
               torch.as_tensor(cur, dtype=torch.int32,
                               device=pb["dmc_cur"].device)}
        for idx, word, n, make in (("X", "XC", dmc.N_UX, cnt_words),
                                   ("S", "SW", dmc.N_UP, ptr_words),
                                   ("U", "UW", dmc.N_UP, ptr_words)):
            i = np.full((B, n), -1, np.int64)
            given = desc.get(idx)
            if given is not None:
                i[:, :given.shape[1]] = given
            w = desc.get(word, make(B, n)).copy()
            for b in range(B):          # duplicates carry the first's word
                _, first, inv = np.unique(i[b], return_index=True,
                                          return_inverse=True)
                w[b] = w[b][first][inv.reshape(-1)]
            for key, a in ((idx, i), (word, w)):
                out["dmc_u" + key] = torch.as_tensor(
                    (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
                    device=pb["dmc_cur"].device)
        return out

    last = levels - 1
    nodes = on_level(min(1, last), 8)
    per_level = [on_level(lev, 3) for lev in range(levels)]
    uX_dups = np.concatenate([nodes[:, :4], on_level(last, 8)], axis=1)
    uX_dups = rng.permuted(np.concatenate([uX_dups, uX_dups], axis=1),
                           axis=1)
    ptr_levels = [on_level(lev, 1) for lev in range(max(1, last))][:8]
    ends = np.array([[0, N - 1]] * B)
    walked = np.concatenate([on_level(lev, 12) for lev in range(levels)],
                            axis=1)
    a = walked[:, rng.permutation(walked.shape[1])[:12]]
    twin = (a + TABLED_NODES) % N
    return {
        "none": state(),
        "ux_dups": state(X=uX_dups),
        "clone_and_path": state(S=nodes, U=nodes),
        "on_path": state(X=np.concatenate(per_level, axis=1)[:, :dmc.N_UX],
                         S=np.concatenate(ptr_levels, axis=1),
                         U=np.concatenate(per_level, axis=1)[:, 1::3][:, :8]),
        "leaf_count": state(X=on_level(last, dmc.N_UX)),
        "ids_0_and_last": state(
            cur=np.full(B, N - 1), X=ends, S=ends[:, 1:], U=ends,
            SW=np.full((B, dmc.N_UP), 0 | (N - 1) << 16),
            UW=np.full((B, dmc.N_UP), (N - 1) | (N - 1) << 16)),
        "twins": state(
            X=np.concatenate([a, twin], axis=1),
            U=np.concatenate([a[:, :4], twin[:, :4]], axis=1),
            S=np.stack([a[:, 1], a[:, 4], twin[:, 4], a[:, 5]], axis=1)),
    }


def _compare(name, levels, pairs):
    import torch
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name} L={levels}: kernel != plain "
                             f"(max abs err {err})")
    return err


def kernels_vs_plain(pb, levels, label):
    """Both DMC kernels once on the state ``pb`` (its tables cloned)
    against their plain versions: -> {name: max abs err}, raising on any
    difference.  The prediction-only walk reads the applied tables."""
    from cmix_tpu_torch.models import dmc
    args = [pb["dmc_cur"]] + [pb[k] for k in dmc.DMC_UPD_KEYS]
    nk, ck = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
    npl, cpl = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
    got = dmc.fused_apply_walk(nk, ck, *args, levels)
    dmc._apply_plain(npl, cpl, *args[1:])
    want = dmc._walk_plain(npl, cpl, args[0], levels)
    errs = {"dmc_fused": _compare(f"dmc_fused, {label}", levels,
                                  [(nk, npl), (ck, cpl)]
                                  + list(zip(got, want)))}
    got = dmc.counts_walk(npl, cpl, args[0], levels)
    errs["dmc_counts"] = _compare(
        f"dmc_counts, {label}", levels,
        [(got, dmc._counts_plain(npl, cpl, args[0], levels))])
    return errs


def _bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def _launchers(pb, levels, copies):
    """{name: [one launch per copy of pb's tables]} for both kernels; the
    fused kernel's set-writes are idempotent, so its repeats apply the same
    descriptors again."""
    import functools
    from cmix_tpu_torch.models import dmc
    args = [pb["dmc_cur"]] + [pb[k] for k in dmc.DMC_UPD_KEYS]
    tables = [(pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone())
              for _ in range(copies)]
    return {"dmc_fused": [functools.partial(dmc.fused_apply_walk, n, c,
                                            *args, levels)
                          for n, c in tables],
            "dmc_counts": [functools.partial(dmc.counts_walk, n, c,
                                             args[0], levels)
                           for n, c in tables]}


def time_level(pb, levels):
    """Both kernels at one depth: device ms with the tables cold (COLD
    copies cycled, so each launch finds its rows out of the L2) and
    warm (one copy), host µs per wrapper call, the plain versions' ms and
    the byte bounds -> {name: res}."""
    from cmix_tpu_torch.models import dmc
    B, N = pb["dmc_nxt"].shape
    cold = _launchers(pb, levels, COLD)
    warm = {k: v[:1] for k, v in cold.items()}
    out = {k: dict(cold=_device_ms(cold[k], REPS),
                   warm=_device_ms(warm[k], REPS)) for k in cold}
    args = [pb["dmc_cur"]] + [pb[k] for k in dmc.DMC_UPD_KEYS]
    npl, cpl = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
    out["dmc_fused"]["plain_ms"] = _events_ms(lambda: (
        dmc._apply_plain(npl, cpl, *args[1:]),
        dmc._walk_plain(npl, cpl, args[0], levels)), 20)
    out["dmc_counts"]["plain_ms"] = _events_ms(
        lambda: dmc._counts_plain(npl, cpl, args[0], levels), 20)
    # least traffic (4 bytes a word): the visited pointer and count words
    # read and cur; for dmc_fused also the descriptors read, the valid
    # ones written and its three outputs; for dmc_counts its (B, 256) out
    walked = (2 ** (levels - 1) - 1) + 2 ** levels
    n_desc = sum(int(pb[k].numel()) for k in dmc.DMC_UPD_KEYS)
    n_valid = sum(int((pb[k] >= 0).sum())
                  for k in ("dmc_uX", "dmc_uS", "dmc_uU"))
    outs = 2 ** levels * 2 + 2 ** (levels - 1)
    for name, nbytes, ops in (
            ("dmc_fused", 4 * (B + n_desc + n_valid + B * (walked + outs)),
             B * (walked + outs)),
            ("dmc_counts", 4 * (B + B * (walked + 256)), B * walked)):
        r = out[name]
        r.update(ms=r["cold"]["ms"], ms_warm=r["warm"]["ms"],
                 host_us=r["cold"]["host_us"], nbytes=nbytes,
                 bound_ms=_bound_ms(nbytes, ops))
        print(f"{name} L={levels} B={B} N={N}: device {r['ms']:.5f} ms "
              f"cold, {r['ms_warm']:.5f} ms warm; wrapper "
              f"{r['host_us']:.2f} us "
              f"host per call; plain {r['plain_ms']:.4f} ms; bound "
              f"{r['bound_ms']:.6f} ms ({nbytes} B); sleep "
              f"{r['cold']['sleep_ms']:.2f} ms covered the enqueue of "
              f"{r['cold']['enqueue_ms']:.2f} ms")
    return out


def _slope(xs, ys):
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def check_dmc_kernels(device, B=256, N=16384, n_steps=50):
    """Both DMC kernels at every depth L in 1..8: bit-exact against their
    plain versions on the real-flow state and on every edge-case set, then
    timed on the device -> {name: {levels: res}}."""
    out = {"dmc_fused": {}, "dmc_counts": {}}
    for levels in LEVELS:
        pb = dmc_descriptors(B, N, levels, n_steps, device)
        cases = {"real flow": pb, **dmc_edge_cases(pb, levels, seed=levels)}
        errs = [kernels_vs_plain(s, levels, label)
                for label, s in cases.items()]
        res = time_level(pb, levels)
        for name in out:
            res[name]["err"] = max(e[name] for e in errs)
            out[name][levels] = res[name]
        print(f"L={levels}: both kernels exact on {len(cases)} descriptor "
              f"sets ({', '.join(cases)})")
    for name, per in out.items():
        slope = _slope(list(per), [r["ms"] for r in per.values()])
        for levels, r in per.items():
            r["floor_ms"] = (levels + 1) * slope
        print(f"{name}: {slope * 1e3:.4f} us per level (cold, fit over "
              f"L=1..8), intercept "
              f"{(per[1]['ms'] - slope) * 1e3:.4f} us; chain floor at L=8 "
              f"{per[8]['floor_ms']:.5f} ms")
    return out


def large_pools(device, B=256, levels=8, n_steps=50):
    """Both DMC kernels at the larger pools of LARGE_POOLS, L=8: bit-exact
    against their plain versions on the real-flow state and every edge
    set (there the fused kernel compares with every descriptor instead
    of using its tables), then timed as at N=16384 -> {N: {name: res}}."""
    out = {}
    for N in LARGE_POOLS:
        pb = dmc_descriptors(B, N, levels, n_steps, device)
        cases = {"real flow": pb, **dmc_edge_cases(pb, levels, seed=N)}
        for label, st in cases.items():
            kernels_vs_plain(st, levels, label)
        out[N] = time_level(pb, levels)
        print(f"N={N}: both kernels exact on {len(cases)} descriptor sets")
    return out


def _gate_record(arc):
    from cmix_tpu_torch import runner
    off = 4 + runner._HDR_LEN
    glen = int.from_bytes(arc[off:off + 2], "little")
    return arc[off + 2:off + 2 + glen]


def _round_trip(label, data, cfg, device, reencode=True, **kw):
    """compress, decompress, and (``reencode``) compress again on
    ``device``: exact round trip, identical re-encode, DMC kernel launches
    > 0 each way.  Returns the launch windows and the archive."""
    import numpy as np
    from cmix_tpu_torch import runner
    with Launches() as enc:
        t0 = time.time()
        arc = runner.compress(data, cfg, device=device, **kw)
        t_enc = time.time() - t0
    with Launches() as dec:
        t0 = time.time()
        back = runner.decompress(arc, device=device,
                                 dictionary=kw.get("dictionary"))
        t_dec = time.time() - t0
    if back != data:
        raise AssertionError(f"{label}: round trip is not exact")
    e, d = enc.counts["dmc_fused"], dec.counts["dmc_fused"]
    if e <= 0 or d <= 0:
        raise AssertionError(f"{label}: dmc_fused launches enc={e} dec={d}:"
                             " not on the path")
    windows, again = [enc, dec], ""
    if reencode:
        with Launches() as enc2:
            if runner.compress(data, cfg, device=device, **kw) != arc:
                raise AssertionError(f"{label}: two encodes differ")
        windows.append(enc2)
        again = (f" re-encode={enc2.counts['dmc_fused']} (identical to the "
                 "first)")
    bpb = 8.0 * len(arc) / len(data)
    if not np.isfinite(bpb) or bpb >= 8.0:
        raise AssertionError(f"{label}: bpb {bpb} is not a compression")
    mb = len(data) / 1e6
    print(f"{label}: exact round trip, {len(arc)} B "
          f"archive, {bpb:.4f} bpb; encode {t_enc:.2f} s "
          f"({mb / t_enc:.6f} MB/s), decode {t_dec:.2f} s "
          f"({mb / t_dec:.6f} MB/s), combined {2 * mb / (t_enc + t_dec):.6f}"
          f" MB/s; dmc_fused launches enc={e} dec={d}{again}")
    return windows, arc


def main_path(device):
    """The fast profile through the runner at CLI widths."""
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.engine import EngineConfig
    data = _text(MAIN_KIB)
    print(f"main path: {len(data)} bytes of text100k.raw, block size cut "
          f"65536 -> {MAIN_BLOCK} ({len(data) // MAIN_BLOCK} blocks in one "
          "group), CLI widths, default gates")
    windows, arc = _round_trip("main path", data, _cli_cfg(MAIN_BLOCK),
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
    return windows + [w], (data, _cli_cfg(MAIN_BLOCK), None, arc)


def portable_cross_device(device, fixture=PORT_FIXTURE, archive=PORT_ARCHIVE,
                          small=PORT_SMALL, batch=PORT_BATCH, what="text",
                          gates=None, cpu=True):
    """The JAX package's PORT=1 archive (of ``gates``, PORT=1 alone by
    default) against the port on the card and (``cpu``) on the CPU: decodes
    exactly, re-encodes byte-identically."""
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.engine import EngineConfig
    with open(fixture, "rb") as f:
        data = f.read()
    with open(archive, "rb") as f:
        ref = f.read()
    cfg = EngineConfig(**small)
    kw = dict(max_batch=batch, gates=gates or {"PORT": 1})
    print(f"portable fixture {os.path.basename(archive)}: {len(data)} B of "
          f"{what}, the JAX package's PORT=1 archive {len(ref)} B "
          f"({cfg.block_size} B blocks, one group, small widths, gate "
          f"record {_gate_record(ref).decode()!r})")
    legs, windows = [], []
    for what, fn, dev in (
            ("card decodes the JAX archive", lambda: runner.decompress(
                ref, device=device), device),
            ("card encodes", lambda: runner.compress(
                data, cfg, device=device, **kw), device),
            ("CPU encodes", lambda: runner.compress(
                data, cfg, device="cpu", **kw), "cpu"))[:3 if cpu else 2]:
        with Launches() as w:
            t0 = time.time()
            out = fn()
            legs.append((what, out, time.time() - t0))
        if dev != "cpu":
            windows.append(w)
            if w.counts["dmc_fused"] <= 0:
                raise AssertionError(f"portable: {what}: no dmc_fused launch")
    if cpu:
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
    return windows, (data, _cli_cfg(PORT_BLOCK), {"PORT": 1}, arc)


def routed_path(device):
    """The content-routed path on the routed fixture: the fast profile at
    CLI widths and at small widths against the CPU, the JAX package's
    PORT=1 archive across devices, and the portable profile at CLI
    widths -> the launch windows."""
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.engine import EngineConfig
    from cmix_tpu_torch.preprocess import wrt
    with open(ROUTED_FIXTURE, "rb") as f:
        data = f.read()
    t0 = time.time()
    payload, meta = wrt.transform(data)
    t_tr = time.time() - t0
    if wrt.untransform(payload, meta) != data:
        raise AssertionError("routed fixture: untransform is not exact")
    types = {e[0] for e in meta}
    want = {wrt.SEG_EXE, wrt.SEG_IMG24, wrt.SEG_AUDIO, wrt.SEG_JPEGC}
    if not want <= types:
        raise AssertionError(f"routed fixture: segments {meta} lack "
                             f"{sorted(want - types)}")
    print(f"routed path: {len(data)} B of x86 code, BMP, WAV and JPEG -> "
          f"{len(payload)} B payload in {t_tr * 1e3:.1f} ms (host), "
          f"segments {meta}; fast profile, CLI "
          f"widths, block size cut 65536 -> {ROUTED_BLOCK} "
          f"({-(-len(payload) // ROUTED_BLOCK)} blocks in one group)")
    windows, arc = _round_trip("routed path", data, _cli_cfg(ROUTED_BLOCK),
                               device)
    gates = _gate_record(arc)
    if gates != b"X86X=2;LMS=2;GRID2=1;JPEGX=1" or not arc[5] & 1:
        raise AssertionError(f"routed path: gate record {gates!r}, flags "
                             f"{arc[5]}: not the routed gates and table")
    print(f"routed path: gate record {gates.decode()!r}, segment table "
          "written")

    # the same model on the CPU and on the card at small widths
    small = EngineConfig(**ROUTED_SMALL)
    with Launches() as w:
        a_gpu = runner.compress(data, small, max_batch=ROUTED_BATCH,
                                device=device)
        ok = runner.decompress(a_gpu, device=device) == data
    windows.append(w)
    a_cpu = runner.compress(data, small, max_batch=ROUTED_BATCH,
                            device="cpu")
    gap = (len(a_gpu) - len(a_cpu)) / len(a_cpu)
    if not ok or abs(gap) > 0.01:
        raise AssertionError(f"routed, small widths: gpu {len(a_gpu)} B vs "
                             f"cpu {len(a_cpu)} B ({gap:+.4%}), round trip "
                             f"{ok}")
    print(f"routed, small widths ({small.block_size} B blocks): gpu archive "
          f"{len(a_gpu)} B, cpu {len(a_cpu)} B ({gap:+.4%}), gpu round trip "
          "exact")

    windows += portable_cross_device(device, ROUTED_FIXTURE, ROUTED_ARCHIVE,
                                     ROUTED_SMALL, ROUTED_BATCH,
                                     "routed content")
    print(f"routed portable path: CLI widths, PORT=1, block size cut 65536 "
          f"-> {ROUTED_PORT_BLOCK}")
    w2, arc = _round_trip("routed portable path", data,
                          _cli_cfg(ROUTED_PORT_BLOCK), device, reencode=False,
                          gates={"PORT": 1})
    digest = hashlib.sha256(arc).hexdigest()
    if digest != ROUTED_PORT_SHA256:
        raise AssertionError(f"routed portable path: archive sha256 {digest}"
                             f" is not the JAX package's {ROUTED_PORT_SHA256}")
    print("routed portable path: the card's archive is byte-identical to the "
          f"JAX package's CPU archive (sha256 {digest[:16]}...)")
    return windows + w2


def routed_nojpegc_path(device):
    """The routed fixture under CMIX_JPEGC=0 (its JPEG a pass-through
    segment, no JPEGX): the JAX package's PORT=1 archive decoded and
    re-encoded byte-identically on the card and on the CPU, and the fast
    profile at CLI widths -> the launch windows."""
    from cmix_tpu_torch.preprocess import wrt
    with open(ROUTED_FIXTURE, "rb") as f:
        data = f.read()
    with EnvVar("CMIX_JPEGC", "0"):
        payload, meta = wrt.transform(data)
        if (meta[-1][0] != wrt.SEG_JPEG
                or wrt.SEG_JPEGC in {e[0] for e in meta}
                or wrt.untransform(payload, meta) != data):
            raise AssertionError(f"routed, CMIX_JPEGC=0: segments {meta}: "
                                 "the JPEG is not a pass-through segment")
        print(f"routed path, CMIX_JPEGC=0: {len(data)} B -> {len(payload)} "
              f"B payload, segments {meta}")
        t0 = time.time()
        windows = portable_cross_device(
            device, ROUTED_FIXTURE, ROUTED_NOJPEGC_ARCHIVE, ROUTED_SMALL,
            ROUTED_BATCH, "routed content, CMIX_JPEGC=0")
        print(f"routed path, CMIX_JPEGC=0: the JAX archive across devices "
              f"{time.time() - t0:.1f} s; fast profile, CLI widths, block "
              f"size cut 65536 -> {ROUTED_BLOCK} "
              f"({-(-len(payload) // ROUTED_BLOCK)} blocks in one group)")
        t0 = time.time()
        w, arc = _round_trip("routed path, CMIX_JPEGC=0", data,
                             _cli_cfg(ROUTED_BLOCK), device)
    gates = _gate_record(arc)
    if gates != b"X86X=2;LMS=2;GRID2=1" or not arc[5] & 1:
        raise AssertionError(f"routed path, CMIX_JPEGC=0: gate record "
                             f"{gates!r}, flags {arc[5]}: not the routed "
                             "gates without JPEGX, and a table")
    print(f"routed path, CMIX_JPEGC=0: gate record {gates.decode()!r}, "
          f"segment table written; the fast leg {time.time() - t0:.1f} s")
    return windows + w


class EnvVar:
    """``os.environ[name] = value`` inside the window (JVAL_ROUTE and
    CMIX_JPEGC: both packages' ``compress`` read them)."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.old


def gated_path(device):
    """The off-by-default mechanisms on the gated fixture, JVAL=2 routed by
    JVAL_ROUTE: the fast profile at CLI widths and at small widths against
    the CPU, the JAX package's PORT=1 archive decoded and re-encoded on the
    card, the portable profile at CLI widths held to the JAX package's
    sha256 -> (launch windows, the step profiles)."""
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.engine import EngineConfig, make_gates
    from cmix_tpu_torch.preprocess import wrt
    from cmix_tpu_torch.utils.profiling import GATED, GATED_PORT
    with open(GATED_FIXTURE, "rb") as f:
        data = f.read()
    payload, meta = wrt.transform(data)
    text = len(data) - os.path.getsize(ROUTED_FIXTURE)
    print(f"gated path: {len(data)} B (the routed fixture and {text} B of "
          f"text with table rows) -> {len(payload)} B payload; fast "
          f"profile, CLI widths, block size cut 65536 -> {GATED_BLOCK} "
          f"({-(-len(payload) // GATED_BLOCK)} blocks in one group), gates "
          f"{GATED}, JVAL_ROUTE={JVAL_ROUTE}")
    with EnvVar("JVAL_ROUTE", JVAL_ROUTE):
        windows, arc = _round_trip("gated path", data, _cli_cfg(GATED_BLOCK),
                                   device, gates=GATED)
        want = make_gates(dict(GATED, X86X=2, LMS=2, GRID2=1, JPEGX=1,
                               JVAL=int(JVAL_ROUTE))).blob()
        gates = _gate_record(arc)
        if gates != want:
            raise AssertionError(f"gated path: gate record {gates!r}, not "
                                 f"{want!r}")
        print(f"gated path: gate record {gates.decode()!r}")

        # the same model on the CPU and on the card at small widths
        small = EngineConfig(**GATED_SMALL)
        kw = dict(max_batch=GATED_BATCH, gates=GATED)
        with Launches() as w:
            a_gpu = runner.compress(data, small, device=device, **kw)
            ok = runner.decompress(a_gpu, device=device) == data
        windows.append(w)
        t0 = time.time()
        a_cpu = runner.compress(data, small, device="cpu", **kw)
        t_cpu = time.time() - t0
        gap = (len(a_gpu) - len(a_cpu)) / len(a_cpu)
        if not ok or abs(gap) > 0.01:
            raise AssertionError(f"gated, small widths: gpu {len(a_gpu)} B vs"
                                 f" cpu {len(a_cpu)} B ({gap:+.4%}), round "
                                 f"trip {ok}")
        print(f"gated, small widths ({small.block_size} B blocks): gpu archive"
              f" {len(a_gpu)} B, cpu {len(a_cpu)} B ({gap:+.4%}; cpu encode "
              f"{t_cpu:.1f} s), gpu round trip exact")

        windows += portable_cross_device(
            device, GATED_FIXTURE, GATED_ARCHIVE, GATED_SMALL, GATED_BATCH,
            "gated content", gates=GATED_PORT, cpu=False)
        print(f"gated portable path: CLI widths, {GATED_PORT}, block size cut"
              f" 65536 -> {GATED_PORT_BLOCK}")
        w2, arc = _round_trip("gated portable path", data,
                              _cli_cfg(GATED_PORT_BLOCK), device,
                              reencode=False, gates=GATED_PORT)
    digest = hashlib.sha256(arc).hexdigest()
    if digest != GATED_PORT_SHA256:
        raise AssertionError(f"gated portable path: archive sha256 {digest} "
                             f"is not the JAX package's {GATED_PORT_SHA256}")
    print("gated portable path: the card's archive is byte-identical to the "
          f"JAX package's CPU archive (sha256 {digest[:16]}...)")
    return windows + w2


def gates_path(device):
    """The remaining gate values (``utils/profiling.LEAN`` and ``KNOBS``)
    on the gated fixture: per set the fast profile at CLI widths (exact
    round trip, identical re-encode, the gates in the record) and at small
    widths against the CPU, the portable profile at CLI widths held to the
    JAX package's sha256; for KNOBS the JAX package's PORT=1 archive
    ``testdata/knobs.tcmx`` decoded and re-encoded on the card -> ({set:
    launch windows}, {label: (data, cfg, gates, fast archive)})."""
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.engine import EngineConfig, make_gates
    from cmix_tpu_torch.utils import profiling
    with open(GATED_FIXTURE, "rb") as f:
        data = f.read()
    windows, archives = {}, {}
    small = EngineConfig(**GATED_SMALL)
    for name in ("lean", "knobs"):
        env = getattr(profiling, name.upper())
        g = make_gates(env)
        label = f"gates path, {name}"
        print(f"{label}: {len(data)} B of the gated fixture, fast profile, "
              f"CLI widths, block size cut 65536 -> {GATES_BLOCK} (one "
              f"group), DMC_LEVELS={g.dmc_levels}, gates {env}")
        cfg = _cli_cfg(GATES_BLOCK)
        w, arc = _round_trip(label, data, cfg, device, gates=env)
        want = make_gates(dict(env, X86X=2, LMS=2, GRID2=1, JPEGX=1)).blob()
        if _gate_record(arc) != want:
            raise AssertionError(f"{label}: gate record "
                                 f"{_gate_record(arc)!r}, not {want!r}")
        archives[f"{label}, fast profile"] = (data, cfg, env, arc)

        kw = dict(max_batch=GATED_BATCH, gates=env)
        with Launches() as ws:
            a_gpu = runner.compress(data, small, device=device, **kw)
            ok = runner.decompress(a_gpu, device=device) == data
        w.append(ws)
        t0 = time.time()
        a_cpu = runner.compress(data, small, device="cpu", **kw)
        t_cpu = time.time() - t0
        gap = (len(a_gpu) - len(a_cpu)) / len(a_cpu)
        if not ok or abs(gap) > GATES_SIZE_TOL:
            raise AssertionError(f"{label}, small widths: gpu {len(a_gpu)} B "
                                 f"vs cpu {len(a_cpu)} B ({gap:+.4%}), round "
                                 f"trip {ok}")
        print(f"{label}, small widths ({small.block_size} B blocks): gpu "
              f"archive {len(a_gpu)} B, cpu {len(a_cpu)} B ({gap:+.4%}; cpu "
              f"encode {t_cpu:.1f} s), gpu round trip exact")

        if name == "knobs":
            w += portable_cross_device(
                device, GATED_FIXTURE, KNOBS_ARCHIVE, GATED_SMALL,
                GATED_BATCH, "gated content", gates=dict(env, PORT=1),
                cpu=False)
        w2, parc = _round_trip(f"{label}, portable profile", data, cfg,
                               device, reencode=False,
                               gates=dict(env, PORT=1))
        digest = hashlib.sha256(parc).hexdigest()
        if digest != GATES_PORT_SHA256[name]:
            raise AssertionError(f"{label}: portable archive sha256 {digest} "
                                 "is not the JAX package's "
                                 f"{GATES_PORT_SHA256[name]}")
        print(f"{label}, portable profile: the card's archive is "
              f"byte-identical to the JAX package's CPU archive (sha256 "
              f"{digest[:16]}...)")
        windows[name] = w + w2
    return windows, archives


def resume_leg(device):
    """--resume on the card: a compress whose journal saver raises after
    the first coding group, then the resumed run, which codes only the rest
    and writes the uninterrupted archive; a fast-profile journal the CPU
    wrote is ignored on the card (every group coded again, the same
    archive); the journal goes once the archive is whole -> launch
    windows."""
    import tempfile
    from cmix_tpu_torch import runner
    from cmix_tpu_torch.engine import EngineConfig
    data = _text(RESUME_KIB)
    cfg = EngineConfig(block_size=SMALL_BLOCK, seg_size=SMALL_BLOCK,
                       tbits=12, mbits=12, ibits=10, pbits=12,
                       lstm_hidden=32, lstm_horizon=4, dmc_nodes=4096)
    groups = -(-len(data) // (SMALL_BLOCK * RESUME_BATCH))
    kw = dict(max_batch=RESUME_BATCH)
    real = runner._resume_save

    class Interrupt(Exception):
        pass

    def crashing_save(path, key, streams):
        real(path, key, streams)
        raise Interrupt

    def interrupted(dev, jp):
        runner._resume_save = crashing_save
        try:
            runner.compress(data, cfg, device=dev, resume_path=jp, **kw)
        except Interrupt:
            pass
        else:
            raise AssertionError("resume: the saver did not interrupt")
        finally:
            runner._resume_save = real
        if not os.path.exists(jp):
            raise AssertionError("resume: no journal after the interrupt")

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    windows = []
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        jp = os.path.join(tmp, "job.tcmr")
        with Launches() as w:
            full = runner.compress(data, cfg, device=device, **kw)
        windows.append(w)
        for label, dev, coded in (
                ("a card journal", device, groups - 1),
                ("the CPU's fast-profile journal", "cpu", groups)):
            interrupted(dev, jp)
            with Launches() as w:
                resumed = runner.compress(data, cfg, device=device,
                                          resume_path=jp, **kw)
            windows.append(w)
            want = coded * SMALL_BLOCK
            if (resumed != full or os.path.exists(jp)
                    or w.counts["dmc_fused"] != want):
                raise AssertionError(
                    f"resume: {label}: archive equal {resumed == full}, "
                    f"journal left {os.path.exists(jp)}, dmc_fused launches "
                    f"{w.counts['dmc_fused']} (want {want})")
            print(f"resume: after {label} interrupted after its first group"
                  f", the card coded {coded} of {groups} groups "
                  f"({w.counts['dmc_fused']} dmc_fused launches) and wrote "
                  f"the uninterrupted archive ({len(full)} B); journal "
                  "removed")
    if runner.decompress(full, device=device) != data:
        raise AssertionError("resume: the archive does not decode")
    return windows


def _unsharded_streams(cfg, gates, data, device):
    """The streams of ``data`` (B, block) through the unsharded
    transcoder (the graph) on the card."""
    import numpy as np
    from cmix_tpu_torch import engine as E
    g = E.make_gates(gates)
    b = data.shape[0]
    _, out, lens = E.make_transcoder(cfg, g, device)(
        E.init_shared(cfg, g, device), E.init_perblock(cfg, g, b, device),
        data, np.zeros((b, cfg.comp_size), np.uint8), E.MODE_ENCODE)
    return [out[i, :lens[i]].tobytes() for i in range(b)]


def _mesh_leg(label, res):
    """Print a run_mesh leg's numbers -> its dmc_fused launches."""
    ranks = res["ranks"]
    launches = 0
    for way in ("encode", "decode"):
        legs = [r[way] for r in ranks if way in r]
        if not legs:
            continue
        launches += sum(x["launches"] for x in legs)
        # on one rank the groups hold one rank each: nothing crosses
        alone = " (groups of one rank)" if len(legs) == 1 else ""
        print(f"{label} {way}: {max(x['ms_per_step'] for x in legs):.3f} ms "
              f"a step (the slowest of {len(legs)} ranks, "
              f"{min(x['ms_per_step'] for x in legs):.3f} the fastest; "
              f"capture {max(x['compile_s'] for x in legs):.3f} s); a "
              f"rank's step all-gathers {legs[0]['gather_bytes']:.0f} B in "
              f"{legs[0]['gathers']:.0f} calls and all-reduces "
              f"{legs[0]['reduce_bytes']:.0f} B in {legs[0]['reduces']:.0f}"
              f"{alone}; dmc_fused launches "
              f"{sum(x['launches'] for x in legs)}")
    if launches <= 0:
        raise AssertionError(f"{label}: no dmc_fused launch on the ranks")
    return launches


def _replicas_agree(label, ranks):
    """After the encode and after the decode (the transcoder's state after
    coding), every replicated shared leaf hashes the same on every rank,
    each tp slice the same on every dp rank that holds it; a decode, which
    replays the encode's updates, ends in the encode's state."""
    from cmix_tpu_torch.parallel.mesh import _SH_TP
    for way in ("encode", "decode"):
        digs = [(r, r["digests"] if way == "encode" else r[way]["digests"])
                for r in ranks if way == "encode" or way in r]
        for r, dg in digs:
            for k, d in dg.items():
                if any(e[k] != d for q, e in digs
                       if k not in _SH_TP or q["tp"] == r["tp"]):
                    raise AssertionError(f"{label}: the replicas of {k} "
                                         f"differ after the {way}")
            if way == "decode" and dg != r["digests"]:
                raise AssertionError(f"{label}: rank {r['rank']}'s state "
                                     "after the decode is not the encode's")


def sharded_phase(device):
    """The sharded transcoder (``cmix_tpu_torch.parallel``) on the card:
    the dry run on 4 ranks (dp=2, tp=2, Gloo), whose ranks then code
    SHARD_LANES lanes of SHARD_BLOCK-byte text at CLI widths on the same
    2 x 2 mesh, eagerly (Gloo's collectives cannot be captured): PORT=1
    byte-identical to the unsharded card archive; the fast profile round
    trip exact on the mesh, within SHARD_SIZE_TOL of the unsharded size;
    the replicas equal after each direction.  Then one NCCL rank, whose
    step and collectives replay as a CUDA graph: PORT=1 (the unsharded
    card archive) and the fast profile (the unsharded graph's streams,
    byte for byte, and an exact round trip), and PORT=1 eagerly, the
    graph's yardstick -> the ranks' dmc_fused launches.  Ranks share the
    card and the host."""
    import numpy as np
    from cmix_tpu_torch.parallel.dryrun import Job, dryrun_multichip, run_mesh
    dev = device.type
    cfg = _cli_cfg(SHARD_BLOCK)
    data = np.frombuffer(_text(4)[:SHARD_LANES * SHARD_BLOCK],
                         np.uint8).reshape(SHARD_LANES, SHARD_BLOCK)
    port, fast = {"PORT": 1}, {}
    refs = {"PORT=1": _unsharded_streams(cfg, port, data, device),
            "fast": _unsharded_streams(cfg, fast, data, device)}
    t0 = time.time()
    # the ranks start once: the dry run, then the CLI-width legs
    res = dryrun_multichip(4, dev, jobs=[Job(data, cfg, port, False),
                                        Job(data, cfg, fast)])
    print(f"sharded: the 2 x 2 mesh of Gloo ranks on the card took "
          f"{time.time() - t0:.1f} s, "
          f"{max(r['ready_s'] for r in res[0]['ranks']):.1f} s of it "
          "from the spawn to the last rank's mesh")
    launches = _mesh_leg("sharded: dry run (dp=2 tp=2, Gloo)", res[0])
    print(f"sharded: {SHARD_LANES} lanes of {SHARD_BLOCK} B of "
          f"text100k.raw, CLI widths")
    t0 = time.time()
    nccl = run_mesh([Job(data, cfg, port, False), Job(data, cfg, fast),
                     Job(data, cfg, port, False, graph=False)], 1, 1, dev)
    print(f"sharded: the NCCL rank took {time.time() - t0:.1f} s, "
          f"{nccl[0]['ranks'][0]['ready_s']:.1f} s of it from the spawn "
          "to its mesh")
    # (label, result, the graph expected, reference, streams must equal it)
    legs = (("PORT=1, 2 x 2 Gloo", res[1], False, "PORT=1", True),
            ("fast profile, 2 x 2 Gloo", res[2], False, "fast", False),
            ("PORT=1, one NCCL rank", nccl[0], True, "PORT=1", True),
            ("fast profile, one NCCL rank", nccl[1], True, "fast", True),
            ("PORT=1, one NCCL rank", nccl[2], False, "PORT=1", True))
    for label, r, graph, ref_key, exact in legs:
        label += ", graph" if graph else ", eager"
        ran = {q["graph"] for q in r["ranks"]}
        if ran != {graph}:
            raise AssertionError(f"sharded: {label}: the ranks ran the "
                                 f"graph {sorted(ran)}")
        launches += _mesh_leg(f"sharded: {label}", r)
        ref = refs[ref_key]
        size, want = sum(map(len, r["streams"])), sum(map(len, ref))
        trips = [q["roundtrip"] for q in r["ranks"] if "roundtrip" in q]
        if not all(trips):
            raise AssertionError(f"sharded: {label}: round trip {trips}")
        trip = "; exact round trip" if trips else ""
        if exact and r["streams"] != ref:
            raise AssertionError(
                f"sharded: {label}: the streams ({size} B) differ from the "
                f"unsharded card archive's ({want} B)")
        gap = (size - want) / want
        if abs(gap) > SHARD_SIZE_TOL:
            raise AssertionError(f"sharded: {label}: {size} B against the "
                                 f"unsharded {want} B ({gap:+.4%})")
        what = (f"byte-identical to the unsharded card archive ({size} B)"
                if exact else f"{size} B against the unsharded {want} B "
                f"({gap:+.4%})")
        _replicas_agree(f"sharded: {label}", r["ranks"])
        print(f"sharded: {label}: {what}{trip}; the replicas of every "
              "shared leaf equal")
    g_ms = nccl[0]["ranks"][0]["encode"]["ms_per_step"]
    e_ms = nccl[2]["ranks"][0]["encode"]["ms_per_step"]
    print(f"sharded: one NCCL rank, PORT=1, CLI widths, {SHARD_LANES} lanes:"
          f" {g_ms:.3f} ms a step through the graph against {e_ms:.3f} ms "
          f"eagerly ({e_ms / g_ms:.2f}x), in this run")
    return launches


def gated_profiles():
    """ms per graphed byte step at B=256 and CLI widths, device busy, idle
    share and kernels per step, with and without the mechanisms, in both
    profiles (``utils/profiling.py``)."""
    from cmix_tpu_torch.utils import profiling
    rows = {}
    for gates in ("default", "gated", "portable", "gated-portable", "lean",
                  "knobs"):
        r = profiling.profile_steps(256, PROFILE_STEPS, gates, True, "cli")
        rows[gates] = r
        print(f"gated: profile, CLI widths, B=256, graph, gates {gates}: wall"
              f" {r['wall_ms_per_step']:.3f} ms/step "
              f"({r['traced_wall_ms_per_step']:.3f} traced), device busy "
              f"{r['device_busy_ms_per_step']:.3f} ms/step, idle share "
              f"{r['device_idle_share']:.4f}, device kernels/step "
              f"{r['device_kernels_per_step']:.2f}; dmc_fused "
              f"{r['dmc_kernels']['dmc_fused_kernel']}; top kernels "
              f"{r['top_device_kernels'][:4]}")
    return rows


class Replays:
    """Each dictionary replay (``engine.make_pretrainer``) in a window:
    its seconds (synchronized), bytes and dmc_fused launches."""

    def __enter__(self):
        import torch
        from cmix_tpu_torch import engine
        from cmix_tpu_torch.models import dmc
        self.engine, self.orig, self.runs = engine, engine.make_pretrainer, []

        def make(cfg, g, dev):
            replay = self.orig(cfg, g, dev)

            def timed(sh, data):
                torch.cuda.synchronize()
                n0, t0 = dmc.fused_apply_walk.launches, time.time()
                out = replay(sh, data)
                torch.cuda.synchronize()
                self.runs.append(dict(
                    seconds=time.time() - t0, bytes=len(data),
                    launches=dmc.fused_apply_walk.launches - n0))
                return out
            return timed
        engine.make_pretrainer = make
        return self

    def __exit__(self, *exc):
        self.engine.make_pretrainer = self.orig


def _dict_leg(label, data, cfg, device, expect_replay, **kw):
    """``_round_trip`` with the dictionary, its replays recorded: one replay
    of at least 640 steps in the encode when ``expect_replay``, none else
    (the cache).  -> (windows, archive, replay launches)."""
    with Replays() as rep:
        windows, arc = _round_trip(label, data, cfg, device,
                                   dictionary=DICT_FILE, **kw)
    runs = rep.runs
    if len(runs) != int(expect_replay) or (runs and runs[0]["launches"] < 640):
        raise AssertionError(f"{label}: replays {runs}, expected "
                             f"{int(expect_replay)} of >= 640 launches")
    gates = _gate_record(arc)
    if arc[5] != 3 or b"WRTW=1" not in gates.split(b";"):
        raise AssertionError(f"{label}: flags {arc[5]}, gate record "
                             f"{gates!r}: not a WRT-coded pretrained archive")
    for r in runs:
        print(f"{label}: pretraining replayed {r['bytes']} B in "
              f"{r['seconds']:.2f} s, {r['launches']} steps (dmc_fused "
              f"launches), {r['seconds'] / r['launches'] * 1e3:.2f} ms per "
              "step at B=1")
    coded = windows[0].counts["dmc_fused"] - sum(r["launches"] for r in runs)
    if coded <= 0:
        raise AssertionError(f"{label}: no dmc_fused launch while coding")
    print(f"{label}: flags 3, gate record {gates.decode()!r}; dmc_fused "
          f"launches in the encode's coding {coded}")
    return windows, arc, sum(r["launches"] for r in runs)


def dict_path(device):
    """Dictionary mode at CLI widths, the fast profile then the portable
    one, each in a fresh pretraining cache -> (launch windows, launches
    of the replays)."""
    import tempfile
    from cmix_tpu_torch.preprocess import wrt
    from cmix_tpu_torch.utils import checkpoint
    data = _text(DICT_KIB)
    t0 = time.time()
    payload, meta = wrt.transform(data, wrt.Dictionary(DICT_FILE))
    t_wrt = time.time() - t0
    if meta[0][0] != wrt.SEG_TEXT or len(payload) >= len(data):
        raise AssertionError(f"dictionary path: WRT did not code the text "
                             f"({meta})")
    print(f"dictionary path: {len(data)} B of text100k.raw -> {len(payload)} "
          f"B of WRT payload with {os.path.basename(DICT_FILE)} in "
          f"{t_wrt * 1e3:.1f} ms (host); CLI widths, block size cut 65536 -> "
          f"{DICT_BLOCK} ({-(-len(payload) // DICT_BLOCK)} blocks in one "
          "group)")
    # the WRT twin (a Python loop) on all of text100k.raw with the shipped
    # list, what --dict auto codes
    from cmix_tpu_torch.runner import AUTO_DICT
    full, d = _text(100), wrt.Dictionary(AUTO_DICT)
    t0 = time.time()
    enc = d.encode(full)
    t1 = time.time()
    if d.decode(enc) != full:
        raise AssertionError("WRT with english.dic: decode is not exact")
    print(f"dictionary path: WRT of text100k.raw with english.dic, {len(full)}"
          f" B -> {len(enc)} B: encode {(t1 - t0) * 1e3:.1f} ms, decode "
          f"{(time.time() - t1) * 1e3:.1f} ms (host)")
    cfg = _cli_cfg(DICT_BLOCK)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    old_dir = checkpoint.CACHE_DIR
    try:
        with tempfile.TemporaryDirectory(dir=build) as cache:
            checkpoint.CACHE_DIR = os.path.join(cache, "fast")
            windows, _, replayed = _dict_leg(
                "dictionary path, fast profile", data, cfg, device, True)
            checkpoint.CACHE_DIR = os.path.join(cache, "portable")
            w2, arc, r2 = _dict_leg(
                "dictionary path, portable profile", data, cfg, device, True,
                reencode=False, gates={"PORT": 1})
    finally:
        checkpoint.CACHE_DIR = old_dir
    digest = hashlib.sha256(arc).hexdigest()
    if digest != DICT_PORT_SHA256:
        raise AssertionError(f"dictionary path: portable archive sha256 "
                             f"{digest} is not the JAX package's "
                             f"{DICT_PORT_SHA256}")
    print("dictionary path: the card's portable archive is byte-identical to "
          f"the JAX package's CPU archive (sha256 {digest[:16]}...)")
    return windows + w2, replayed + r2


def step_ms(device, label, env, cfg, B, steps, graph=True):
    """Host-clock ms per byte step (synchronized) over one segment of
    ``steps`` steps on bench4m.raw lanes, after one segment of warm-up
    (the graph's capture included), as the transcoder runs them:
    ``engine.make_segment_fn``'s graph, or the eager step."""
    import dataclasses
    import numpy as np
    import torch
    from cmix_tpu_torch import engine as E
    g = E.make_gates(env)
    cfg = dataclasses.replace(cfg, seg_size=steps)
    raw = np.fromfile(os.path.join(ROOT, "testdata", "bench4m.raw"),
                      dtype=np.uint8).reshape(256, -1)[:B]
    inp = torch.as_tensor(raw[:, :2 * steps].T.copy(), device=device)
    seg = E.make_segment_fn(cfg, g, device, graph)
    with torch.no_grad():
        seg.start(E.init_shared(cfg, g, device),
                  E.init_perblock(cfg, g, B, device), E.init_coder(B, device),
                  torch.zeros((B, cfg.comp_size), dtype=torch.uint8,
                              device=device),
                  torch.zeros(B, dtype=torch.int64, device=device))
        seg.run(inp[:steps])
        torch.cuda.synchronize()
        t0 = time.time()
        seg.run(inp[steps:])
        torch.cuda.synchronize()
    ms = (time.time() - t0) / steps * 1e3
    print(f"step: {label}, B={B}, {'graph' if graph else 'eager'}: "
          f"{ms:.3f} ms per byte step over {steps} steps after {steps} "
          f"warm-up -> {B / ms * 1e3 / 1e6:.6f} MB/s one direction")
    return ms


def step_times(device):
    from cmix_tpu_torch import engine as E
    bench = E.EngineConfig(block_size=16384, tbits=18, mbits=18, ibits=16,
                           lstm_hidden=256, seg_size=2048, dmc_nodes=16384,
                           lstm_horizon=4)
    for B in (256, 1):
        for graph in (True, False):
            step_ms(device, "bench profile (bench widths and gates)",
                    E.BENCH_GATES, bench, B, BENCH_STEPS, graph)
    cli = _cli_cfg(16384)
    for label, env in (("fast profile, default gates", {}),
                       ("portable profile, PORT=1", {"PORT": 1})):
        for B in (16, 256):
            for graph in (True, False):
                step_ms(device, f"{label}, CLI widths", env, cli, B,
                        STEP_STEPS, graph)


class Eager:
    """The runner's transcoder on the eager step (``graph=False``) inside
    the window: the graph's yardstick."""

    def __enter__(self):
        import functools
        from cmix_tpu_torch import engine, runner
        self.runner, self.orig = runner, runner.make_transcoder
        runner.make_transcoder = functools.partial(engine.make_transcoder,
                                                   graph=False)
        return self

    def __exit__(self, *exc):
        self.runner.make_transcoder = self.orig


def graph_vs_eager_archives(device, archives):
    """The main path's archives (the graph's, made by the earlier phases)
    against the eager step's at the same widths: byte-identical."""
    from cmix_tpu_torch import runner
    windows = []
    for label, (data, cfg, gates, arc) in archives.items():
        with Launches() as w, Eager():
            t0 = time.time()
            eager = runner.compress(data, cfg, device=device, gates=gates)
        windows.append(w)
        if eager != arc:
            raise AssertionError(f"graph: {label}: the graph's archive "
                                 f"({len(arc)} B) is not the eager step's "
                                 f"({len(eager)} B)")
        print(f"graph: {label}: the graph's archive is byte-identical to the "
              f"eager step's ({len(arc)} B, sha256 "
              f"{hashlib.sha256(arc).hexdigest()[:16]}...; eager encode "
              f"{time.time() - t0:.2f} s, dmc_fused launches "
              f"{w.counts['dmc_fused']})")
    return windows


def graph_vs_eager_replay(device):
    """A dictionary replay (``engine.make_pretrainer``, B=1) at CLI widths
    through the graph and through the eager step, in both profiles: the
    states equal leaf for leaf under PORT=1, within 2e-5 in the fast
    profile (its integer leaves exactly)."""
    import numpy as np
    import torch
    from cmix_tpu_torch import engine as E
    from cmix_tpu_torch.utils.checkpoint import _leaves
    with open(DICT_FILE, "rb") as f:
        data = np.frombuffer(f.read()[:DICT_EAGER_BYTES].replace(
            b"\n", b" "), np.uint8)
    cfg = _cli_cfg(DICT_BLOCK)
    for label, env in (("fast", {"WRTW": 1}), ("portable", {"PORT": 1,
                                                            "WRTW": 1})):
        g = E.make_gates(env)
        states, secs = [], []
        for graph in (True, False):
            torch.cuda.synchronize()
            t0 = time.time()
            states.append(dict(_leaves(E.make_pretrainer(cfg, g, device,
                                                         graph)(
                E.init_shared(cfg, g, device), data))))
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
        worst = 0.0
        for name, x in states[0].items():
            y = states[1][name]
            if x.dtype.is_floating_point and not g.port:
                worst = max(worst, float((x - y).abs().max()))
            elif not torch.equal(x, y):
                raise AssertionError(f"graph: {label} replay: {name} differs "
                                     "from the eager replay's")
        if worst > 2e-5:
            raise AssertionError(f"graph: {label} replay: float leaves "
                                 f"{worst} from the eager replay's")
        steps = -(-len(data) // DICT_BLOCK) * DICT_BLOCK
        print(f"graph: {label} dictionary replay ({len(data)} B, {steps} "
              f"steps at B=1): the graph's state equals the eager replay's "
              f"({len(states[0])} leaves, integer leaves exact, float max abs "
              f"diff {worst}); graph {secs[0]:.2f} s "
              f"({secs[0] / steps * 1e3:.3f} ms/step), eager {secs[1]:.2f} s "
              f"({secs[1] / steps * 1e3:.3f} ms/step)")


def graph_profiles():
    """Wall ms, device busy ms and idle share per step, graph and eager, at
    bench widths and gates, B=256 and B=1 (``utils/profiling.py``)."""
    from cmix_tpu_torch.utils import profiling
    rows = []
    for batch in (256, 1):
        for graph in (True, False):
            r = profiling.profile_steps(batch, PROFILE_STEPS, "bench", graph)
            rows.append(r)
            print(f"graph: profile, bench widths and gates, B={batch}, "
                  f"{r['step']}: wall {r['wall_ms_per_step']:.3f} ms/step "
                  f"({r['traced_wall_ms_per_step']:.3f} traced), "
                  f"device busy {r['device_busy_ms_per_step']:.3f} ms/step, "
                  f"idle share {r['device_idle_share']:.4f}, host calls/step: "
                  f"aten {r['aten_calls_per_step']:.2f}, launches "
                  f"{r['kernel_launches_per_step']:.2f}; device kernels/step "
                  f"{r['device_kernels_per_step']:.2f}; dmc_fused "
                  f"{r['dmc_kernels']['dmc_fused_kernel']}")
    return rows


def bench_segment(device):
    """The port's bench (``cmix_tpu_torch/bench.py``) on one segment:
    ``bench.run`` at its config and gates with the block cut to BENCH_SEG
    steps, on the first BENCH_SEG bytes of each of bench4m.raw's 256
    blocks.  Its three passes (first encode with the graph's capture, timed
    encode, timed decode) go through one ``engine.make_transcoder`` with a
    Meter each: exact round trip, the timed encode's streams equal to the
    first's, no stream overflowing, and one dmc_fused launch per byte step
    in each pass; the run's numbers printed as JSON."""
    import dataclasses
    import numpy as np
    from cmix_tpu_torch import bench
    # the bench's config and gates, whatever the environment holds
    cfg, gates = bench.bench_config({})
    cfg = dataclasses.replace(cfg, block_size=BENCH_SEG, seg_size=BENCH_SEG)
    data = np.frombuffer(bench.corpus(), np.uint8).reshape(256, -1)[
        :, :BENCH_SEG].tobytes()
    with Launches() as w:
        r = bench.run(data, cfg, gates, device)
    if not r["fits"]:
        raise AssertionError("bench segment: a stream overflows")
    if not r["reencode_identical"]:
        raise AssertionError("bench segment: the timed encode's streams "
                             "differ from the first encode's")
    if not r["roundtrip"]:
        raise AssertionError("bench segment: the decoded history is not "
                             "the input")
    for label, p in r["passes"].items():
        if p["dmc_fused_launches"] != BENCH_SEG:
            raise AssertionError(f"bench segment {label}: dmc_fused launches "
                                 f"{p['dmc_fused_launches']}, not "
                                 f"{BENCH_SEG}")
    if w.counts["dmc_fused"] != 3 * BENCH_SEG:
        raise AssertionError(f"bench segment: dmc_fused launches "
                             f"{w.counts['dmc_fused']}, not {3 * BENCH_SEG}")
    for label, report in r["meters"].items():
        print(f"graph: bench segment ({BENCH_SEG} steps x 256 lanes of "
              f"bench4m.raw, bench widths and gates) {label}: "
              f"{json.dumps(report)}")
    print("graph: bench segment run: " + json.dumps(
        {k: v for k, v in r.items() if k not in ("meters", "streams")}))
    return [w]


def graph_phase(device, archives):
    windows = graph_vs_eager_archives(device, archives)
    graph_vs_eager_replay(device)
    graph_profiles()
    return windows + bench_segment(device)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from cmix_tpu_torch.bench import card as _card
    from cmix_tpu_torch.engine import resolve_device
    device = resolve_device("cuda")
    # the CPU legs code a few lanes of tiny tensors, where threads only add
    # overhead (the CPU tests run one thread too)
    torch.set_num_threads(1)
    t_all = time.time()
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        print(f"phase {name}: {time.time() - t0:.1f} s")
        return out

    phase("build", build_kernels)
    res = phase("kernels", check_dmc_kernels, device)
    phase("large pools", large_pools, device)
    windows, main_arc = phase("main path", main_path, device)
    windows += phase("portable fixture", portable_cross_device, device)
    w, port_arc = phase("portable path", portable_cli, device)
    windows += w
    routed = phase("routed path", routed_path, device)
    windows += routed
    nojpegc = phase("routed path, CMIX_JPEGC=0", routed_nojpegc_path, device)
    windows += nojpegc
    gated = phase("gated path", gated_path, device)
    windows += gated
    gates, gates_arcs = phase("gates path", gates_path, device)
    for w in gates.values():
        windows += w
    windows += phase("resume", resume_leg, device)
    dicts, replayed = phase("dict path", dict_path, device)
    windows += dicts
    sharded = phase("sharded", sharded_phase, device)
    phase("step times", step_times, device)
    phase("gated profiles", gated_profiles)
    windows += phase("graph", graph_phase, device, dict({
        "main path, fast profile": main_arc,
        "portable path, PORT=1": port_arc}, **gates_arcs))
    replaces = {"dmc_fused": "cmix_tpu/models/dmc.py:153",
                "dmc_counts": "cmix_tpu/models/dmc.py:287"}
    kernels = []
    for name, per_level in res.items():
        r = per_level[8]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cmix_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(w.counts[name] for w in windows)
            + (sharded if name == "dmc_fused" else 0),
            "launches_routed": sum(w.counts[name] for w in routed),
            "launches_routed_nojpegc": sum(w.counts[name] for w in nojpegc),
            "launches_gated": sum(w.counts[name] for w in gated),
            "launches_gates": sum(w.counts[name] for ws in gates.values()
                                  for w in ws),
            # the gates path by walk depth: LEAN at 8, KNOBS at 4
            "launches_gates_l8": sum(w.counts[name] for w in gates["lean"]),
            "launches_gates_l4": sum(w.counts[name]
                                     for w in gates["knobs"]),
            "launches_dict": sum(w.counts[name] for w in dicts),
            "launches_pretrain": replayed if name == "dmc_fused" else 0,
            # the sharded phase's ranks (dmc_counts is on no path)
            "launches_sharded": sharded if name == "dmc_fused" else 0,
            "max_abs_err": max(v["err"] for v in per_level.values()),
            "ms": r["ms"], "ms_warm": r["ms_warm"],
            "host_us": r["host_us"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "floor_ms": r["floor_ms"], "floor_by": "latency",
            "library_ms": None})
    summary = ", ".join(f"{k['name']} launches={k['launches']} (routed "
                        f"path {k['launches_routed']}, routed under "
                        f"CMIX_JPEGC=0 {k['launches_routed_nojpegc']}, "
                        f"gated path "
                        f"{k['launches_gated']}, gates path "
                        f"{k['launches_gates']}: at L=8 "
                        f"{k['launches_gates_l8']}, at L=4 "
                        f"{k['launches_gates_l4']}, dictionary path "
                        f"{k['launches_dict']}, of them pretraining "
                        f"{k['launches_pretrain']}, sharded phase "
                        f"{k['launches_sharded']})" for k in kernels)
    print(f"kernels: {summary} over the coding paths; both exact at L=1..8 "
          f"on the real-flow states and {len(EDGE_CASES)} edge-case sets "
          f"(max_abs_err 0); times at L=8, B=256 (device, tables cold); "
          f"dmc_counts is on no path of the system, as its TPU original; "
          f"{time.time() - t_all:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
