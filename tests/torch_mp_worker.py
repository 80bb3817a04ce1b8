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
"""

import os
import subprocess
import sys

import numpy as np

LANES = 4
TIMEOUT = 120.0
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
