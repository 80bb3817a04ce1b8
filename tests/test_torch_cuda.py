"""Tests of the port that need an NVIDIA GPU (marker ``cuda``; each skips
without a card).  On a machine with a card but without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Imports nothing of JAX, so it runs where only the port is installed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.mixer.ilstm import LAUNCHES, ilstm_shared_byte_update
from cmix_tpu_torch.models import dmc
from cmix_tpu_torch.utils.profiling import GATE_SETS

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return E.resolve_device("cuda")


@pytest.mark.parametrize("levels", range(1, 9))
def test_dmc_kernel_matches_plain_version(gpu, levels):
    B, N = 16, 4096
    pb = dmc.init_dmc_perblock(N, B, gpu)
    rng = np.random.default_rng(levels)
    for _ in range(40):
        dmc._apply_plain(pb["dmc_nxt"], pb["dmc_cnt"],
                         *(pb[k] for k in dmc.DMC_UPD_KEYS))
        cw, vis, wn = dmc._walk_plain(pb["dmc_nxt"], pb["dmc_cnt"],
                                      pb["dmc_cur"], levels)
        pb.update(dmc.plan_step(pb, {"cw": cw, "vis": vis, "wn": wn},
                                torch.as_tensor(rng.integers(0, 256, B),
                                                device=gpu), levels))
    args = [pb["dmc_cur"]] + [pb[k] for k in dmc.DMC_UPD_KEYS]
    nk, ck = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
    n0 = dmc.fused_apply_walk.launches
    got = dmc.fused_apply_walk(nk, ck, *args, levels)
    assert dmc.fused_apply_walk.launches == n0 + 1
    npl, cpl = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
    dmc._apply_plain(npl, cpl, *args[1:])
    want = dmc._walk_plain(npl, cpl, args[0], levels)
    torch.cuda.synchronize()
    for a, b in [(nk, npl), (ck, cpl)] + list(zip(got, want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("levels", range(1, 9))
def test_counts_kernel_matches_plain_version(gpu, levels):
    B, N = 16, 4096
    pb = dmc.init_dmc_perblock(N, B, gpu)
    rng = np.random.default_rng(10 + levels)
    for _ in range(40):
        upd, walk = dmc.predict_step(pb, levels)
        pb.update(upd)
        pb.update(dmc.plan_step(pb, walk, torch.as_tensor(
            rng.integers(0, 256, B), device=gpu), levels))
    nxt, cnt, cur = pb["dmc_nxt"], pb["dmc_cnt"], pb["dmc_cur"]
    n0 = dmc.counts_walk.launches
    got = dmc.counts_walk(nxt, cnt, cur, levels)
    assert dmc.counts_walk.launches == n0 + 1
    want = dmc._counts_plain(nxt, cnt, cur, levels)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[:, 1 << levels:].any()


@pytest.mark.parametrize("levels", range(1, 9))
def test_kernels_match_plain_versions_on_edge_cases(gpu, levels):
    """Both kernels on chip_smoke's edge-case descriptor sets (forwarded
    writes on the walked path, a clone and a path word on one node, ids 0
    and N-1, twins 16384 apart, ...): bit-exact, tables included
    (kernels_vs_plain raises)."""
    pb = chip_smoke.dmc_descriptors(16, 32768, levels, 30, gpu)
    for name, st in chip_smoke.dmc_edge_cases(pb, levels, levels).items():
        errs = chip_smoke.kernels_vs_plain(st, levels, name)
        assert errs == {"dmc_fused": 0, "dmc_counts": 0}


def test_fused_kernel_at_the_largest_pool(gpu):
    """N=65536, above the fused kernel's tabled pools (it compares with
    every descriptor instead): ids up to N-1 and twins (the edge sets)."""
    pb = chip_smoke.dmc_descriptors(4, 65536, 8, 30, gpu)
    for name, st in {"real flow": pb,
                     **chip_smoke.dmc_edge_cases(pb, 8, 65536)}.items():
        assert chip_smoke.kernels_vs_plain(st, 8, name) == {
            "dmc_fused": 0, "dmc_counts": 0}


def test_kernel_wrapper_rejects_bad_operands(gpu):
    pb = dmc.init_dmc_perblock(4096, 2, gpu)
    args = [pb[k] for k in ("dmc_nxt", "dmc_cnt", "dmc_cur")
            + dmc.DMC_UPD_KEYS]
    with pytest.raises(ValueError):
        dmc.fused_apply_walk(*args[:2], args[2].long(), *args[3:], 8)
    with pytest.raises(ValueError):
        dmc.fused_apply_walk(*args, 9)
    n0 = dmc.fused_apply_walk.launches, dmc.counts_walk.launches
    empty = [a[:0] for a in args]       # a grid of 0 CTAs: the card refuses
    with pytest.raises(RuntimeError):
        dmc.fused_apply_walk(*empty, 8)
    with pytest.raises(RuntimeError):
        dmc.counts_walk(*empty[:3], 8)
    assert (dmc.fused_apply_walk.launches, dmc.counts_walk.launches) == n0


def test_roundtrip_on_gpu_goes_through_the_kernel(gpu):
    cfg = E.EngineConfig(block_size=64, seg_size=64, tbits=12, mbits=12,
                         ibits=10, pbits=12, lstm_hidden=32,
                         lstm_horizon=4, dmc_nodes=4096)
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[:192]
    dmc.fused_apply_walk.launches = 0
    arc = runner.compress(data, cfg, device=gpu)
    assert dmc.fused_apply_walk.launches == 64
    assert runner.decompress(arc, device=gpu) == data
    assert runner.compress(data, cfg, device=gpu) == arc


@pytest.mark.parametrize("gates", [{"PORT": 1}, {"PORT": 1, "ILSTM_ADAM": 1,
                                                   "ILSTM_LRX": 6}])
def test_portable_roundtrip_on_gpu_matches_the_cpu(gpu, gates):
    """PORT=1 on the card: exact round trip through the kernel, and the
    archive byte-identical to the CPU's (the portable contract)."""
    cfg = E.EngineConfig(block_size=64, seg_size=64, tbits=12, mbits=12,
                         ibits=10, pbits=12, lstm_hidden=32,
                         lstm_horizon=4, dmc_nodes=4096)
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[4000:4160]
    kw = dict(max_batch=2, gates=gates)
    dmc.fused_apply_walk.launches = 0
    ilstm_shared_byte_update.launches = 0
    arc = runner.compress(data, cfg, device=gpu, **kw)
    assert dmc.fused_apply_walk.launches == 128          # two groups
    # the LSTM's chain: its launches an update, once a byte step
    assert ilstm_shared_byte_update.launches == 128 * LAUNCHES
    assert runner.decompress(arc, device=gpu) == data
    assert runner.compress(data, cfg, device="cpu", **kw) == arc


# ---- the captured byte step (engine.make_segment_fn)

GRAPH_KW = dict(block_size=128, seg_size=32, tbits=12, mbits=12, ibits=10,
                pbits=12, lstm_hidden=32, lstm_horizon=4, dmc_nodes=4096)


def _lanes(b, n, off=0):
    with open("testdata/text100k.raw", "rb") as f:
        raw = f.read()[off:off + b * n]
    return np.frombuffer(raw, np.uint8).reshape(b, n).copy()


@pytest.mark.parametrize("gates", [{}, {"PORT": 1}, GATE_SETS["gated"],
                                   GATE_SETS["gated-portable"],
                                   GATE_SETS["lean"], GATE_SETS["knobs"],
                                   dict(GATE_SETS["knobs"], PORT=1)])
def test_graph_archives_equal_the_eager_steps(gpu, gates):
    """Two groups of 3 lanes through one transcoder (the second copied
    into the captured graph's buffers), four segments each: the graph's
    streams and histories equal the eager step's bit for bit, both count
    one dmc_fused launch per byte step, and the graph decodes its own
    streams exactly."""
    cfg, g = E.EngineConfig(**GRAPH_KW), E.make_gates(gates)
    groups = [_lanes(3, 128), _lanes(3, 128, 5000)]
    res = {}
    for graph in (True, False):
        trans = E.make_transcoder(cfg, g, gpu, graph=graph)
        dmc.fused_apply_walk.launches = 0
        res[graph] = [trans(E.init_shared(cfg, g, gpu),
                            E.init_perblock(cfg, g, 3, gpu), inp,
                            np.zeros((3, cfg.comp_size), np.uint8),
                            E.MODE_ENCODE) for inp in groups]
        assert dmc.fused_apply_walk.launches == 2 * 128
    for a, b in zip(res[True], res[False]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    trans = E.make_transcoder(cfg, g, gpu)
    for inp, (_, out, _) in zip(groups, res[True]):
        hist, _, _ = trans(E.init_shared(cfg, g, gpu),
                           E.init_perblock(cfg, g, 3, gpu),
                           np.zeros_like(inp), out, E.MODE_DECODE)
        assert np.array_equal(hist, inp)


@pytest.mark.parametrize("gates", [{}, {"PORT": 1}])
def test_graph_counts_its_launches_per_replay(gpu, gates):
    """The capture records one dmc_fused launch, no dmc_counts launch and,
    in PORT=1, the LSTM chain's launches; the warm-up's and the capture's
    host calls are not counted, each replay is."""
    cfg, g = E.EngineConfig(**GRAPH_KW), E.make_gates(gates)
    lstm = LAUNCHES if gates else 0
    seg = E.make_segment_fn(cfg, g, gpu)
    n0 = dmc.launch_counts()
    with torch.no_grad():
        seg.start(E.init_shared(cfg, g, gpu), E.init_perblock(cfg, g, 2, gpu),
                  E.init_coder(2, gpu),
                  torch.zeros((2, cfg.comp_size), dtype=torch.uint8,
                              device=gpu),
                  torch.zeros(2, dtype=torch.int64, device=gpu))
        assert seg.per_replay == [1, 0, lstm]
        assert dmc.launch_counts() == n0
        seg.run(torch.as_tensor(_lanes(2, 32).T.copy(), device=gpu))
    assert dmc.launch_counts() == [n0[0] + 32, n0[1], n0[2] + 32 * lstm]


def test_capture_runs_its_warm_up_under_sync_debug_error(gpu):
    """The second warm-up runs under set_sync_debug_mode("error"): a step
    that reads a value back to the host raises there, naming the
    operator; the mode is restored either way."""
    cfg, g = E.EngineConfig(**GRAPH_KW), E.make_gates({})

    def start(seg):
        with torch.no_grad():
            seg.start(E.init_shared(cfg, g, gpu),
                      E.init_perblock(cfg, g, 2, gpu), E.init_coder(2, gpu),
                      torch.zeros((2, cfg.comp_size), dtype=torch.uint8,
                                  device=gpu),
                      torch.zeros(2, dtype=torch.int64, device=gpu))
    start(E.make_segment_fn(cfg, g, gpu))
    assert torch.cuda.get_sync_debug_mode() == 0
    seg = E.make_segment_fn(cfg, g, gpu)
    body = seg.body

    def syncing(st):
        body(st)
        int(st["t"])
    seg.body = syncing
    with pytest.raises(RuntimeError, match="synchroniz"):
        start(seg)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("gates", [{}, {"PORT": 1}])
def test_graphed_pretraining_equals_the_eager_replay(gpu, gates):
    """A dictionary replay at B=1 through the graph gives the eager
    replay's state: leaf for leaf."""
    cfg = E.EngineConfig(**dict(GRAPH_KW, block_size=64))
    g = E.make_gates(gates)
    with open("testdata/mini.dic", "rb") as f:
        data = np.frombuffer(f.read()[:300], np.uint8)
    got, want = (E.make_pretrainer(cfg, g, gpu, graph=graph)(
        E.init_shared(cfg, g, gpu), data) for graph in (True, False))
    from cmix_tpu_torch.utils.checkpoint import _leaves
    want = dict(_leaves(want))
    for name, x in _leaves(got):
        assert torch.equal(x, want[name]), name


def test_profiler_counts_each_kernel_once(gpu):
    """utils/profiling.py sums the device's own events: an operator's
    entry carries its kernels' time too, and summing both counted every
    eager kernel twice (2.0x the graph's busy time).  The eager step and
    its graph run nearly the same kernels, so their busy times agree."""
    from cmix_tpu_torch.utils import profiling
    rows = [profiling.profile_steps(4, 4, "default", graph)
            for graph in (True, False)]
    busy = [r["device_busy_ms_per_step"] for r in rows]
    assert 0.8 < busy[1] / busy[0] < 1.25, busy
    kernels = [r["device_kernels_per_step"] for r in rows]
    assert 0.9 < kernels[1] / kernels[0] <= 1.0, kernels
    assert rows[0]["kernel_launches_per_step"] == 1.0      # cudaGraphLaunch
    assert rows[0]["dmc_kernels"]["dmc_fused_kernel"][
        "launches_per_step"] == 1.0


def test_sharded_ranks_on_the_card_equal_unsharded(gpu):
    """Two ranks sharing the card under Gloo (mesh dp=1 x tp=2): the PORT=1
    streams are the unsharded card archive's, through the DMC kernel."""
    from cmix_tpu_torch.parallel.dryrun import Job, run_mesh
    cfg = E.EngineConfig(block_size=64, seg_size=64, tbits=12, mbits=12,
                         ibits=10, pbits=12, lstm_hidden=32,
                         lstm_horizon=4, dmc_nodes=4096)
    with open("testdata/text100k.raw", "rb") as f:
        data = np.frombuffer(f.read()[:256], np.uint8).reshape(4, 64)
    res = run_mesh([Job(data, cfg, {"PORT": 1}, decode=False)], 1, 2,
                   "cuda", timeout=300)[0]
    assert res["streams"] == chip_smoke._unsharded_streams(
        cfg, {"PORT": 1}, data, gpu)
    assert [r["encode"]["launches"] for r in res["ranks"]] == [64, 64]


def test_nccl_rank_replays_the_sharded_graph(gpu):
    """One NCCL rank (mesh 1 x 1, its collectives over groups of one rank)
    codes through the captured sharded step: PORT=1 and the fast profile
    write the unsharded graph's streams byte for byte (the step's float
    work is the unsharded step's, in the same order), the fast archive
    decodes exactly, and each replay counts one dmc_fused launch."""
    from cmix_tpu_torch.parallel.dryrun import Job, run_mesh
    cfg = E.EngineConfig(**dict(GRAPH_KW, block_size=64))
    data = _lanes(4, 64)
    res = run_mesh([Job(data, cfg, {"PORT": 1}, decode=False),
                    Job(data, cfg, {})], 1, 1, "cuda", timeout=300)
    for r, gates in zip(res, ({"PORT": 1}, {})):
        rank = r["ranks"][0]
        assert rank["backend"] == "nccl" and rank["graph"]
        assert r["streams"] == chip_smoke._unsharded_streams(cfg, gates,
                                                             data, gpu)
        assert rank["encode"]["launches"] == 64
    assert res[1]["ranks"][0]["roundtrip"]
    assert res[1]["ranks"][0]["decode"]["digests"] == \
        res[1]["ranks"][0]["digests"]


def test_sharded_capture_runs_its_warm_up_under_sync_debug_error(gpu):
    """The sharded step's capture (an NCCL group of one rank in this
    process) warms up under set_sync_debug_mode("error"): it passes, and a
    collective that reads a value back to the host raises there."""
    import torch.distributed as dist
    from cmix_tpu_torch.parallel import mesh as M
    from cmix_tpu_torch.parallel.dryrun import free_port
    cfg, g = E.EngineConfig(**GRAPH_KW), E.make_gates({"PORT": 1})
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        m = M.make_mesh(1, 1)

        def start():
            comm = M.ShardComm(cfg, g, m, gpu)
            comm.start(2)
            seg = E.make_segment_fn(cfg, g, gpu, True, comm)
            sh, pb = M.sharded_group_state(cfg, g, 2, m, gpu)
            with torch.no_grad():
                seg.start(sh, pb, E.init_coder(2, gpu),
                          torch.zeros((2, cfg.comp_size), dtype=torch.uint8,
                                      device=gpu),
                          torch.zeros(2, dtype=torch.int64, device=gpu))
            return seg, comm
        seg, comm = start()
        assert seg.graph and seg.ready
        assert seg.per_replay == [1, 0, LAUNCHES]
        assert comm.counts == dict(gather_bytes=0, gathers=0,
                                   reduce_bytes=0, reduces=0)
        assert seg.comm_per_replay["gathers"] == 2
        assert not comm.hist.any()
        assert torch.cuda.get_sync_debug_mode() == 0
        rows = M.ShardComm.rows

        def syncing(self, *args):
            out = rows(self, *args)
            int(out.reshape(-1)[0])
            return out
        M.ShardComm.rows = syncing
        try:
            with pytest.raises(RuntimeError, match="synchroniz"):
                start()
        finally:
            M.ShardComm.rows = rows
        assert torch.cuda.get_sync_debug_mode() == 0
    finally:
        dist.destroy_process_group()



# ---- the Meter's device records (utils/profiling.py)

@pytest.mark.parametrize("gates", [{}, {"PORT": 1}])
def test_meter_times_each_replay_and_the_steps_parts(gpu, gates):
    """Two groups of 3 lanes through runner.compress with a Meter: one
    device sample per replay (block_size a group), each group's six parts
    of its last replay summing to within 2% of that replay's own sample,
    and the archive byte-identical to the one coded without a Meter, and
    decoded exactly with one."""
    from cmix_tpu_torch.utils.profiling import Meter
    cfg = E.EngineConfig(**GRAPH_KW)
    data = _lanes(6, 128).tobytes()
    kw = dict(max_batch=3, gates=gates, device=gpu)
    arc = runner.compress(data, cfg, **kw)
    m = Meter()
    assert runner.compress(data, cfg, meter=m, **kw) == arc
    assert list(m.replay_ms) == [0] and list(m.part_ms) == [0]
    replays, parts = m.replay_ms[0], m.part_ms[0]
    assert len(replays) == 2 * 128 and min(replays) > 0
    assert len(parts) == 2
    for i, p in enumerate(parts):
        assert list(p) == list(E.PARTS) and min(p.values()) > 0
        last = replays[128 * (i + 1) - 1]
        assert abs(sum(p.values()) - last) <= 0.02 * last, (p, last)
    d = Meter()
    assert runner.decompress(arc, device=gpu, meter=d) == data
    assert len(d.replay_ms[0]) == 2 * 128 and len(d.part_ms[0]) == 2


@pytest.mark.parametrize("gates", [{}, {"PORT": 1}])
def test_meter_times_the_routed_part_on_routed_content(gpu, gates):
    """The routed fixture (x86 code, a 24-bit image, audio and a JPEG) in
    one group through runner.compress with a Meter: its routed gates
    (GRID2 and JPEGX, and LMS=2 outside PORT) add the ``routed`` part
    after ``predict``, and the seven parts sum to within 2% of the group's
    last replay; the archive is the one coded without a Meter and decodes
    exactly with one.  Text keeps exactly the six parts
    (``test_meter_times_each_replay_and_the_steps_parts``)."""
    from cmix_tpu_torch.utils.profiling import Meter
    cfg = E.EngineConfig(**GRAPH_KW)
    with open(chip_smoke.ROUTED_FIXTURE, "rb") as f:
        data = f.read()
    kw = dict(max_batch=64, gates=gates, device=gpu)
    arc = runner.compress(data, cfg, **kw)
    m = Meter()
    assert runner.compress(data, cfg, meter=m, **kw) == arc
    (p,) = m.part_ms[0]
    assert list(p) == [E.PARTS[0], E.ROUTED, *E.PARTS[1:]]
    assert min(p.values()) > 0
    last = m.replay_ms[0][-1]
    assert abs(sum(p.values()) - last) <= 0.02 * last, (p, last)
    d = Meter()
    assert runner.decompress(arc, device=gpu, meter=d) == data
    assert list(d.part_ms[0][0]) == list(p)


def test_timed_graph_replays_once_a_step(gpu):
    """The timed segment keeps one CUDAGraph.replay call a step (what the
    benchmark's trace counts), and its outputs are the untimed graph's."""
    cfg, g = E.EngineConfig(**GRAPH_KW), E.make_gates({})
    inp = torch.as_tensor(_lanes(2, 32).T.copy(), device=gpu)
    out, calls = {}, []
    orig = torch.cuda.CUDAGraph.replay

    def counted(graph):
        calls.append(1)
        orig(graph)
    for timed in (False, True):
        seg = E.make_segment_fn(cfg, g, gpu, timed=timed)
        with torch.no_grad():
            seg.start(E.init_shared(cfg, g, gpu),
                      E.init_perblock(cfg, g, 2, gpu), E.init_coder(2, gpu),
                      torch.zeros((2, cfg.comp_size), dtype=torch.uint8,
                                  device=gpu),
                      torch.zeros(2, dtype=torch.int64, device=gpu))
            calls.clear()
            torch.cuda.CUDAGraph.replay = counted
            try:
                out[timed] = [x.clone() for x in seg.run(inp)]
            finally:
                torch.cuda.CUDAGraph.replay = orig
        assert len(calls) == 32
        torch.cuda.synchronize()
        if timed:
            assert len(seg.replay_ms(seg.ring)) == 32
            assert list(seg.timer.ms()) == list(E.PARTS)
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
