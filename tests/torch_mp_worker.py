"""Ranks of the port's multi-process tests (test_torch_distributed.py), and
the launcher the tests share.

As a script, one rank of ``tests/mp_worker.py``'s checks on the port's
``parallel/distributed.py`` under Gloo on the CPU:

    torch_mp_worker.py <rank> <world> <port> <outdir>

Each rank holds LANES lanes of the blocks ``inputs(world)`` makes: the
ordered gather must give every rank's lengths and payloads in block order
(mp_worker's pattern: block i has length i + 1 and payload fill i, and a
random one from a seed), ``gather_streams`` the trimmed streams, and
``broadcast_state`` rank 0's tensors on every rank.  Rank 0 writes the
gathered random blocks to <outdir>/gather.npz; every rank prints OK.

``static_body_job`` is a rank of tests/test_torch_sharded_static.py, run
through ``parallel/dryrun.run_mesh``'s ``rank_fn``.
"""

import os
import subprocess
import sys

import numpy as np

LANES = 4
TIMEOUT = 120.0
STATIC_STEPS = 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inputs(world, seed=0):
    """(lens (B,), payload (B, 16) uint8) of LANES * world random blocks."""
    rng = np.random.RandomState(seed)
    n = LANES * world
    return (rng.randint(0, 17, size=n).astype(np.int64),
            rng.randint(0, 256, size=(n, 16)).astype(np.uint8))


def run_ranks(world, outdir, timeout=TIMEOUT):
    """Run this script as ``world`` ranks; each rank's (returncode,
    output).  A rank still running after ``timeout`` seconds of its wait
    gets every rank killed and the test failed."""
    from cmix_tpu_torch.parallel.dryrun import free_port
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), str(outdir)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def static_body_job(cfg, g, blocks, mesh, device, spec):
    """A rank of tests/test_torch_sharded_static.py (``run_mesh``'s
    ``rank_fn``): STATIC_STEPS byte steps of the static sharded body
    (``engine.make_static_step`` with a ``ShardComm``, the callable the
    graph captures) run eagerly beside the eager sharded step
    (``make_byte_step(..., comm)``) from one state on the rank's lanes of
    ``blocks``.  -> the names of what differs (each step's outputs, every
    leaf, the every-lane history), whether every static buffer kept its
    storage, and whether a graph asked for under Gloo raised ValueError
    (``make_segment_fn`` and ``make_sharded_transcoder``)."""
    import torch
    from cmix_tpu_torch import engine as E
    from cmix_tpu_torch.parallel.mesh import (
        ShardComm, make_sharded_transcoder, sharded_group_state)
    from cmix_tpu_torch.utils.checkpoint import _leaves, clone_state
    b = blocks.shape[0]
    n = b // mesh.n_dp
    lo = mesh.dp_rank * n
    inp = torch.as_tensor(np.ascontiguousarray(blocks[lo:lo + n].T))
    body_comm, step_comm = (ShardComm(cfg, g, mesh, device)
                            for _ in range(2))
    body_comm.start(b)
    step_comm.start(b)
    sh, pb = sharded_group_state(cfg, g, b, mesh, device)
    cd = E.init_coder(n, device)
    comp = torch.zeros((n, cfg.comp_size), dtype=torch.uint8)
    mode = torch.zeros(n, dtype=torch.int64)
    S = cfg.seg_size
    st = dict(sh=clone_state(sh), pb=clone_state(pb), cd=clone_state(cd),
              comp=comp, mode=mode, inp=inp[:S].clone(),
              e32=torch.zeros((S, n, 8), dtype=torch.int64),
              c32=torch.zeros((S, n), dtype=torch.int64),
              t=torch.zeros((), dtype=torch.int64))

    def ptrs():
        return {k: v.data_ptr() for k, v in _leaves(st)} | {
            "comm.hist": body_comm.hist.data_ptr()}
    before = ptrs()
    body = E.make_static_step(cfg, g, device, body_comm)
    step = E.make_byte_step(cfg, g, device, step_comm)
    differ = []
    with torch.no_grad():
        for s in range(STATIC_STEPS):
            body(st)
            sh, pb, cd, e32, c32 = step(sh, pb, cd, comp, inp[s],
                                        torch.tensor(s), mode)
            if not (torch.equal(st["e32"][s], e32)
                    and torch.equal(st["c32"][s], c32)):
                differ.append(f"outputs at step {s}")
    got = dict(_leaves(st))
    for name, x in _leaves(dict(sh=sh, pb=pb, cd=cd)):
        if not (x.dtype == got[name].dtype and torch.equal(got[name], x)):
            differ.append(name)
    if not torch.equal(body_comm.hist, step_comm.hist):
        differ.append("comm.hist")
    refused = []
    for make in (lambda: E.make_segment_fn(cfg, g, device, True, body_comm),
                 lambda: make_sharded_transcoder(cfg, g, mesh, device, True)):
        try:
            make()
            refused.append(False)
        except ValueError:
            refused.append(True)
    return dict(differ=differ, leaves=len(got), storage_kept=ptrs() == before,
                t=int(st["t"]), gloo_graph_refused=refused)


def _rank(rank, world, port, outdir):
    import torch
    torch.set_num_threads(1)
    from cmix_tpu_torch.parallel.distributed import (
        broadcast_state, gather_streams, global_mesh, host_block_span,
        init_distributed, make_ordered_gather)

    n, p = init_distributed(f"localhost:{port}", world, rank)
    assert (n, p) == (world, rank), (n, p)
    mesh = global_mesh(n_dp=world, n_tp=1)
    assert mesh.shape == (world, 1) and mesh.dp_rank == rank
    lo, hi = host_block_span(LANES * world)
    assert (lo, hi) == (LANES * rank, LANES * rank + LANES), (lo, hi)

    # mp_worker.py's pattern: block i carries length i + 1 and fill i
    gather = make_ordered_gather(mesh)
    lens = np.arange(lo, hi, dtype=np.int32) + 1
    pay = np.tile(np.arange(lo, hi, dtype=np.uint8)[:, None], (1, 16))
    all_lens, all_pay = gather(lens, pay)
    assert np.array_equal(all_lens, np.arange(LANES * world) + 1), all_lens
    for i in range(LANES * world):
        assert (all_pay[i, :i + 1] == i).all(), (i, all_pay[i])

    # random blocks: the lengths and the streams trimmed to them
    lens, pay = inputs(world)
    all_lens, all_pay = gather(lens[lo:hi], pay[lo:hi])
    streams = gather_streams(mesh, pay[lo:hi], lens[lo:hi])
    assert np.array_equal(all_lens, lens), all_lens
    assert streams == [pay[i, :lens[i]].tobytes() for i in range(len(lens))]

    # broadcast: rank 0's values replace every other rank's
    state = {"w": torch.arange(32, dtype=torch.float32) * (rank == 0),
             "lstm": {"b": torch.full((3,), rank, dtype=torch.int32)}}
    broadcast_state(state, mesh)
    assert torch.equal(state["w"], torch.arange(32, dtype=torch.float32))
    assert torch.equal(state["lstm"]["b"], torch.zeros(3, dtype=torch.int32))

    if rank == 0:
        np.savez(os.path.join(outdir, "gather.npz"), lens=all_lens,
                 payload=all_pay)
    torch.distributed.destroy_process_group()
    print("OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
