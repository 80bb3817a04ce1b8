"""A tp rank's row write (``parallel/mesh.ShardComm.set_rows``) in fixed
shapes, on the CPU with no process group: for every table the mesh splits
over tp (``_SH_TP``: axis 0 and axis 1) and each rank of tp=2, the write of
duplicate indices, among them rows only the other rank owns, leaves the
rank's slice equal to the same slice of the unsharded write
(``engine._set_rows``).  A rank that owns none of the rows leaves its slice
as it was.  No collective runs (the tp group is a sentinel that no
collective could take)."""

import pytest
import torch

from cmix_tpu_torch import engine as E
from cmix_tpu_torch.parallel.distributed import Mesh
from cmix_tpu_torch.parallel.mesh import _SH_TP, ShardComm, shard_state
from torch_parity import RUNNER_KW

CPU = torch.device("cpu")
N_TP = 2


def _view2d(t):
    """The 2-d view the byte step writes through (``engine._set_rows``):
    the flat arena as rows of one, a 3-d table as its rows of the last
    axis."""
    return t.view(-1, 1) if t.dim() == 1 else t.view(-1, t.shape[-1])


def _write(key, rank, pick):
    """(the rank's slice after ShardComm.set_rows, the same slice of the
    unsharded write) of 48 entries whose global rows ``pick`` chooses."""
    cfg, g = E.EngineConfig(**RUNNER_KW), E.make_gates({})
    gen = torch.Generator().manual_seed(7 + rank)
    sh = E.init_shared(cfg, g, CPU)
    whole = torch.randint(-2**31, 2**31 - 1, sh[key].shape,
                          dtype=torch.int64, generator=gen).to(sh[key].dtype)
    mine = shard_state({key: whole}, N_TP, rank)[key]
    comm = ShardComm(cfg, g, Mesh(1, N_TP, rank, tp_group=object()), CPU)
    lo, hi = comm.span[key]
    n = comm.n_rows[key]
    rows = pick(gen, lo, hi, n)
    lead = 1 if _SH_TP[key] == 0 else whole.numel() // whole.shape[-1] // n
    lead_i = torch.randint(0, lead, rows.shape, generator=gen)
    flat = lead_i * n + rows
    w2 = _view2d(whole)
    vals = torch.randint(-2**31, 2**31 - 1, (flat.numel(), w2.shape[1]),
                         dtype=torch.int64, generator=gen).to(w2.dtype)
    want = whole.clone()
    E._set_rows(_view2d(want), flat, vals)
    E._set_rows(_view2d(mine), flat, vals, comm, key)
    return mine, shard_state({key: want}, N_TP, rank)[key]


def _both(gen, lo, hi, n):
    # rows of both ranks, each drawn from a few so that rows repeat
    own = torch.randint(lo, hi, (6,), generator=gen)
    other = torch.randint(0, n, (6,), generator=gen)
    return torch.cat([own, other, other, own])[torch.randperm(24,
                                                              generator=gen)]


def _others(gen, lo, hi, n):
    # only rows the other rank owns
    other = torch.cat([torch.arange(0, lo), torch.arange(hi, n)])
    return other[torch.randint(0, len(other), (24,), generator=gen)]


@pytest.mark.parametrize("rank", range(N_TP))
@pytest.mark.parametrize("key", sorted(_SH_TP))
def test_tp_write_equals_the_unsharded_slice(key, rank):
    got, want = _write(key, rank, _both)
    assert torch.equal(got, want), key


@pytest.mark.parametrize("rank", range(N_TP))
@pytest.mark.parametrize("key", ["aux_tbl", "bank"])
def test_tp_write_of_only_the_other_ranks_rows_changes_nothing(key, rank):
    got, want = _write(key, rank, _others)
    assert torch.equal(got, want), key
