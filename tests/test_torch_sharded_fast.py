"""The port's sharded transcoder in the fast profile, ranks spawned under
Gloo on the CPU, meshes dp=2 x tp=1 and dp=1 x tp=2, 4 lanes of 64-byte
text blocks at tests/torch_parity.RUNNER_KW's widths: an archive decodes
exactly on the mesh that coded it, its size is within SIZE_TOL of the
unsharded archive's, and after the encode every replicated shared leaf
hashes the same on every rank and every tp slice the same on every dp
rank that holds it.  Also ``shard_state``/``unshard_state`` on a state
converted from the JAX package's init."""

import jax
import pytest
import torch

from cmix_tpu import engine as je
from cmix_tpu.parallel import mesh as jm
from cmix_tpu_torch import convert
from cmix_tpu_torch import engine as E
from cmix_tpu_torch.parallel.dryrun import Job, run_mesh
from cmix_tpu_torch.parallel.mesh import (
    _SH_TP, perblock_shardings, shard_state, shared_shardings, unshard_state)
from test_torch_sharded_port import blocks, unsharded_streams
from torch_mp_worker import TIMEOUT
from torch_parity import RUNNER_KW, SIZE_TOL

torch.set_num_threads(1)


@pytest.mark.parametrize("n_dp,n_tp", [(2, 1), (1, 2)])
def test_fast_mesh_round_trip_and_replicas(n_dp, n_tp):
    cfg = E.EngineConfig(**RUNNER_KW)
    data = blocks(cfg)
    res = run_mesh([Job(data, cfg)], n_dp, n_tp, device="cpu",
                   timeout=TIMEOUT)[0]
    assert all(r["roundtrip"] for r in res["ranks"])
    size = sum(map(len, res["streams"]))
    ref = sum(map(len, unsharded_streams(cfg, {}, data)))
    assert abs(size - ref) <= SIZE_TOL * ref, (size, ref)
    ranks = res["ranks"]
    for r in ranks:
        for k, d in r["digests"].items():
            if k in _SH_TP:
                same = [q for q in ranks if q["tp"] == r["tp"]]
            else:
                same = ranks
            assert all(q["digests"][k] == d for q in same), k
    if n_tp == 2:
        assert ranks[0]["digests"]["bank"] != ranks[1]["digests"]["bank"]


def test_shard_then_unshard_is_the_identity():
    cfg = je.EngineConfig(**RUNNER_KW)
    sh = convert.from_jax_state(jax.device_get(je.init_shared(cfg)), {}, {},
                                device="cpu")[0]
    for n_tp in (2, 3):
        shards = [shard_state(sh, n_tp, p) for p in range(n_tp)]
        for k, axis in _SH_TP.items():
            assert sum(s[k].shape[axis] for s in shards) == sh[k].shape[axis]
            assert shards[-1][k].shape[axis] <= shards[0][k].shape[axis]
        back = unshard_state(shards)
        assert back.keys() == sh.keys()
        for k, v in sh.items():
            if isinstance(v, dict):
                assert back[k] is v
            else:
                assert torch.equal(back[k], v), k


def _axis(spec, name):
    return list(spec).index(name) if name in tuple(spec) else None


def _specs(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def test_shardings_match_the_jax_package():
    """The split axis of every leaf: the JAX package's PartitionSpecs
    (its bank chunks are the port's one bank), tp on the five tables, dp
    on every per-block leaf."""
    cfg = je.EngineConfig(**RUNNER_KW)
    sh, pb = (convert.from_jax_state(jax.device_get(je.init_shared(cfg)),
                                     jax.device_get(je.init_perblock(cfg)),
                                     {}, device="cpu")[:2])
    mesh = jm.make_mesh(2, 2)
    jsh = jm.shared_shardings(mesh, cfg)
    tsh = shared_shardings(sh)
    for k, spec in jsh.items():
        if isinstance(spec, dict):
            assert all(_axis(x, "tp") is None for x in _specs(spec))
            assert not any(jax.tree_util.tree_leaves(tsh[k]))
        else:
            assert tsh["bank" if k.startswith("bank") else k] == _axis(
                spec, "tp"), k
    assert {k for k, v in tsh.items() if isinstance(v, int)} == set(_SH_TP)
    jpb = jm.perblock_shardings(mesh, cfg)
    assert all(_axis(x, "dp") == 0 for x in _specs(jpb))
    assert set(jax.tree_util.tree_leaves(perblock_shardings(pb))) == {0}
