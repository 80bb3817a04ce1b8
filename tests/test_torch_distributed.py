"""The port's parallel/distributed.py against cmix_tpu/parallel/distributed.py:
the single-process no-op, the block spans, and ranks spawned under Gloo on
the CPU running tests/mp_worker.py's checks (tests/torch_mp_worker.py), the
ordered gather held to the JAX package's on the 8 virtual CPU devices."""

import numpy as np
import pytest
import torch

import torch_mp_worker as W
from cmix_tpu.parallel import distributed as jd
from cmix_tpu_torch.parallel import distributed as td
from cmix_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)
WORLD = 2


def test_init_single_process_is_a_no_op():
    assert td.init_distributed() == (1, 0) == jd.init_distributed()
    mesh = make_mesh(1, 1)
    assert mesh.shape == (1, 1) and mesh.axis_names == ("dp", "tp")
    assert mesh.dp_group is None and mesh.tp_group is None
    x = torch.arange(6)
    assert mesh.all_gather(x, mesh.dp_group) is x


def test_host_block_span_formula():
    """distributed.py:59-63's split, over a grid of blocks, worlds and
    ranks; one process: every block, as the JAX package's."""
    assert td.host_block_span(13) == jd.host_block_span(13) == (0, 13)
    for n in range(0, 40):
        for world in range(1, 9):
            per = -(-n // world)
            spans = [td.host_block_span(n, world, r) for r in range(world)]
            assert spans == [(min(r * per, n), min((r + 1) * per, n))
                             for r in range(world)]
            assert sum(hi - lo for lo, hi in spans) == n


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    return W.run_ranks(WORLD, out), out


def test_two_ranks_gather_and_broadcast(two_ranks):
    """Two processes, LANES lanes each: ordered lengths and payloads,
    trimmed streams, rank 0's state on every rank."""
    outs, _ = two_ranks
    for rc, out in outs:
        assert rc == 0 and "OK" in out, out[-3000:]


def test_ordered_gather_matches_the_jax_package(two_ranks):
    """The port's gather over two ranks against the JAX package's
    make_ordered_gather over a dp=8 mesh of virtual devices, on the same
    blocks: the same lengths, the same trimmed payloads, in block order."""
    import jax.numpy as jnp
    _, out = two_ranks
    lens, pay = W.inputs(WORLD)
    mesh = jd.global_mesh(n_dp=8, n_tp=1)
    jl, jp = jd.make_ordered_gather(mesh)(jnp.asarray(lens, jnp.int32),
                                          jnp.asarray(pay))
    jl, jp = np.asarray(jl), np.asarray(jp)
    got = np.load(out / "gather.npz")
    assert np.array_equal(got["lens"], jl)
    for i in range(len(lens)):
        assert np.array_equal(got["payload"][i, :jl[i]], jp[i, :jl[i]])
    assert [s for s in jd.gather_streams(mesh, pay, lens)] == [
        got["payload"][i, :got["lens"][i]].tobytes()
        for i in range(len(lens))]


def test_dryrun_cli_on_the_cpu():
    """``python -m cmix_tpu_torch.parallel.dryrun 2 --device cpu``: two
    ranks (dp=1, tp=2) encode and decode 2 blocks, round trip exact."""
    import os
    import subprocess
    import sys
    res = subprocess.run(
        [sys.executable, "-m", "cmix_tpu_torch.parallel.dryrun", "2",
         "--device", "cpu"], cwd=W.ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=W.ROOT), timeout=W.TIMEOUT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "dryrun_multichip ok: mesh dp=1 tp=2, encoded 2 blocks" in \
        res.stdout and "decode roundtrip=True" in res.stdout
