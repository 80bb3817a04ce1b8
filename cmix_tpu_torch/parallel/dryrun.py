"""Multi-rank dry run of the sharded transcoder, and the rank launcher.

Port of ``__graft_entry__.dryrun_multichip`` (which stays as it is):

    python -m cmix_tpu_torch.parallel.dryrun N [--device cpu]

spawns N ranks on the mesh dp = N/2, tp = 2 (tp = 1 for an odd N), encodes
2*dp blocks at the JAX package's dry-run config, decodes them on the same
mesh from fresh state and checks the round trip.

``run_mesh`` is the launcher under it: one process per rank, joined over
``tcp://localhost:<a free port>``, each coding the same jobs in turn
through ``mesh.make_sharded_transcoder`` (the ranks start once for all
jobs); for every job each rank reports whether it replayed a CUDA graph,
its wall seconds, its collective bytes, its DMC kernel launches and the
digests of its shared state after each direction, and rank 0 the streams.
On the card the ranks run under Gloo (eagerly) unless there is a card for
each (then NCCL, through the graph), and a rank's device is card
``rank % device_count``.
"""

import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port():
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class Job:
    """One coding job of ``run_mesh``: ``blocks`` (B, block_size) uint8,
    ``cfg`` an ``engine.EngineConfig``, ``gates`` a gate mapping; with
    ``decode`` the archive is decoded on the same mesh from fresh state;
    ``graph`` is ``make_sharded_transcoder``'s (None: its default)."""
    blocks: np.ndarray
    cfg: object
    gates: dict = None
    decode: bool = True
    graph: bool = None


def run_mesh(jobs, n_dp=1, n_tp=1, device="cuda", backend=None,
             timeout=900.0, rank_fn=None):
    """Code each ``Job`` of ``jobs`` in turn on one n_dp x n_tp mesh of
    spawned ranks.  Waits ``timeout`` seconds for the ranks, then kills
    them all and raises; stops them and raises at the first rank that
    fails.  -> [dict(streams=[bytes of each block], ranks=[each rank's
    report]) for each job]; a report's ``ready_s`` is the seconds from
    the spawn to the rank's mesh.  ``rank_fn``, "module:function"
    importable on the ranks, takes the place of ``code_job`` (same
    arguments; its report's ``streams``, if any, are rank 0's streams)."""
    n = n_dp * n_tp
    if backend is None:
        backend = ("nccl" if device != "cpu"
                   and torch.cuda.device_count() >= n else "gloo")
    with tempfile.TemporaryDirectory(prefix="cmix_mesh_") as tmp:
        for i, job in enumerate(jobs):
            np.save(os.path.join(tmp, f"blocks{i}.npy"),
                    np.ascontiguousarray(job.blocks, dtype=np.uint8))
        with open(os.path.join(tmp, "job.json"), "w") as f:
            json.dump(dict(jobs=[dict(cfg=dataclasses.asdict(j.cfg),
                                      gates=j.gates or {}, decode=j.decode,
                                      graph=j.graph)
                                 for j in jobs], rank_fn=rank_fn,
                           n_dp=n_dp, n_tp=n_tp, device=device,
                           backend=backend, port=free_port(),
                           spawned=time.time()), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]), OMP_NUM_THREADS="1")
        procs, logs = [], []
        for r in range(n):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cmix_tpu_torch.parallel.dryrun",
                 "--rank-job", tmp, str(r)], env=env, cwd=_ROOT,
                stdout=log, stderr=subprocess.STDOUT))
        try:
            # a rank that fails leaves the others waiting in a collective:
            # stop at the first failure, or when the time is out
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the {n} ranks did not finish in "
                                       f"{timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        failed = [r for r, p in enumerate(procs) if p.returncode]
        if failed:
            with open(os.path.join(tmp, f"rank{failed[0]}.log")) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"ranks {failed} of {n} failed; rank "
                               f"{failed[0]}'s output ends:\n{tail}")
        reports = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        results = []
        for i in range(len(jobs)):
            path = os.path.join(tmp, f"streams{i}.npz")
            z = np.load(path) if os.path.exists(path) else None
            results.append(dict(
                streams=None if z is None else [
                    z["out"][k, :z["lens"][k]].tobytes()
                    for k in range(len(z["lens"]))],
                ranks=[rep[i] for rep in reports]))
    return results


def code_job(cfg, g, blocks, mesh, device, spec):
    """One rank's part of a coding job: ``blocks`` (B, block_size) encoded
    through ``make_sharded_transcoder`` from a fresh group state, and with
    ``spec["decode"]`` decoded from fresh state.  -> the rank's report:
    ``graph``, per direction its seconds, the graph's capture seconds
    (``compile_s``, at the first group), ms a step without them,
    collective bytes and calls a step and ``dmc_fused`` launches, the
    ``state_digests`` of its shared state after the encode (``digests``)
    and after the decode (the decode's ``digests``), the round trip's
    result and ``streams`` (out, lens)."""
    from cmix_tpu_torch.engine import MODE_DECODE, MODE_ENCODE
    from cmix_tpu_torch.models import dmc
    from cmix_tpu_torch.parallel.mesh import (
        make_sharded_transcoder, sharded_group_state, state_digests)
    from cmix_tpu_torch.utils.profiling import Meter
    trans = make_sharded_transcoder(cfg, g, mesh, device, spec.get("graph"))
    comm, b = trans.comm, blocks.shape[0]

    def timed(sh, pb, inp, comp, mode):
        for w in dmc.WRAPPERS:
            w.launches = 0
        before, meter = dict(comm.counts), Meter()
        t0 = time.perf_counter()
        res = trans(sh, pb, inp, comp, mode, meter)
        if device.type == "cuda":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        cap = meter.t.get("compile", 0.0)
        return res, dict(
            s=sec, compile_s=cap,
            ms_per_step=(sec - cap) * 1e3 / cfg.block_size,
            launches=dmc.fused_apply_walk.launches,
            **{k: (v - before[k]) / cfg.block_size
               for k, v in comm.counts.items()})

    (_, out, lens), enc = timed(*sharded_group_state(cfg, g, b, mesh, device),
                                blocks, np.zeros((b, cfg.comp_size), np.uint8),
                                MODE_ENCODE)
    # the state after coding is the transcoder's: under the graph a later
    # group's state is copied into its buffers, not kept in the arrays
    # handed in
    report = dict(graph=trans.graph, encode=enc, streams=(out, lens),
                  digests=state_digests(trans.state()[0]))
    if spec["decode"]:
        (hist, _, _), dec = timed(*sharded_group_state(cfg, g, b, mesh,
                                                       device),
                                  np.zeros_like(blocks), out, MODE_DECODE)
        report.update(decode=dict(dec, digests=state_digests(
            trans.state()[0])), roundtrip=bool(np.array_equal(hist, blocks)))
    return report


def _rank_job(tmp, rank):
    """One rank of ``run_mesh``'s jobs in ``tmp``: writes rank<r>.json, its
    report of each job (and rank 0 streams<i>.npz)."""
    from cmix_tpu_torch.engine import EngineConfig, make_gates, resolve_device
    from cmix_tpu_torch.parallel.distributed import init_distributed
    from cmix_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "job.json")) as f:
        job = json.load(f)
    n_dp, n_tp = job["n_dp"], job["n_tp"]
    device = job["device"]
    if device != "cpu":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    device = resolve_device(device)
    init_distributed(f"localhost:{job['port']}", n_dp * n_tp, rank,
                     job["backend"])
    mesh = make_mesh(n_dp, n_tp)
    ready_s = time.time() - job["spawned"]
    fn = code_job
    if job["rank_fn"]:
        mod, name = job["rank_fn"].split(":")
        fn = getattr(importlib.import_module(mod), name)

    reports = []
    for i, spec in enumerate(job["jobs"]):
        blocks = np.load(os.path.join(tmp, f"blocks{i}.npy"))
        report = dict(rank=rank, dp=mesh.dp_rank, tp=mesh.tp_rank,
                      backend=job["backend"], device=str(device),
                      ready_s=ready_s,
                      **fn(EngineConfig(**spec["cfg"]),
                           make_gates(spec["gates"]), blocks, mesh, device,
                           spec))
        streams = report.pop("streams", None)
        reports.append(report)
        if rank == 0 and streams is not None:
            np.savez(os.path.join(tmp, f"streams{i}.npz"), out=streams[0],
                     lens=streams[1])
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(reports, f)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     jobs=()) -> list:
    """One full (training) transcode of 2*dp blocks on an n-rank mesh (dp
    = n/2, tp = 2; tp = 1 for an odd n) at ``__graft_entry__.py``'s
    dry-run config, decoded on the same mesh from fresh state: the round
    trip must be exact.  Prints the JAX package's line.  ``jobs``, more
    ``Job``s, run on the same ranks after it, so the ranks start once.
    -> run_mesh's results, the dry run's first."""
    from cmix_tpu_torch.engine import EngineConfig
    n_tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_dp = n_devices // n_tp
    cfg = EngineConfig(block_size=64, tbits=10, mbits=10, ibits=8,
                       lstm_hidden=32)
    b = n_dp * 2
    inp = np.tile(np.arange(cfg.block_size, dtype=np.uint8)[None], (b, 1))
    res = run_mesh([Job(inp, cfg), *jobs], n_dp, n_tp, device, backend)
    lens = np.array([len(s) for s in res[0]["streams"]])
    if not all(r["roundtrip"] for r in res[0]["ranks"]):
        raise AssertionError("multichip decode did not reproduce the "
                             "encoded bytes")
    print(f"dryrun_multichip ok: mesh dp={n_dp} tp={n_tp}, encoded {b} "
          f"blocks, lens={lens[:4]}, decode roundtrip=True")
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-job"]:
        _rank_job(argv[1], int(argv[2]))
        return 0
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m cmix_tpu_torch.parallel.dryrun",
        description="Dry run of the sharded transcoder on N ranks")
    ap.add_argument("n", type=int, help="ranks (mesh dp=N/2, tp=2)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
