"""dp x tp sharding of the transcoder on torch.distributed.

Port of cmix_tpu/parallel/mesh.py.  The axes are the JAX package's:

* ``dp`` (block parallel): dp rank d codes lanes [d*B/dp, (d+1)*B/dp) of a
  coding group; its positional state (``pb``), coder and DMC walk are its
  own lanes'.  The throughput axis.
* ``tp`` (table parallel): the large shared hash tables (``_SH_TP``) are
  split on their row axis, each tp rank holding one contiguous slice.

JAX's GSPMD inserts every collective; here the byte step places its own
(``engine.make_byte_step(..., comm=...)`` with a ``ShardComm``):

* a row read of a tp table is a gather of the rank's own rows, the others
  zero, summed over tp (int32 tables, one non-zero term per entry: exact);
* a row write computes the duplicate winner (``engine._winner_pos``) on
  the full index list, which every tp rank holds, and writes only the
  rank's rows, in fixed shapes (``engine._masked_rows``: an entry another
  rank owns repeats the write of one this rank owns);
* the shared updates (``engine._update_tree_b``, the LSTM's step) run on
  every lane's inputs, all-gathered over dp in lane order, so every rank
  applies the unsharded step's update and every replica of a shared leaf
  stays identical after every step, in both profiles (no float sum is
  reordered);
* the arena's writes (match positions, indirect values) are all-gathered
  over dp before the winner rule; match cursors read any lane's history,
  which each rank keeps for every lane (B bytes all-gathered a step).

No collective reads a value back to the host, and no write has a shape
that depends on the data, so under NCCL (or without a process group) the
step is captured as a CUDA graph with its collectives, the port's
counterpart of the JAX package's sharded ``jax.jit``; Gloo's collectives
stage through host memory, so a Gloo rank runs the step eagerly.

pp/ep do not map to this format (no layer pipeline, no routed experts).
"""

import hashlib

import numpy as np
import torch

from cmix_tpu_torch.engine import (
    D12_ROWS, EngineConfig, Gates, _masked_rows, init_perblock, init_shared,
    make_transcoder, resolve_device)
from cmix_tpu_torch.parallel.distributed import (
    Mesh, global_mesh, host_block_span, make_ordered_gather)

# shared tables whose row axis is split over tp (cmix_tpu/parallel/mesh.py
# _SH_TP; the port's bank is one table, not JAX's chunks); every other
# shared leaf is replicated, ppm_ck included
_SH_TP = {
    "bank": 1,        # (NB, R, 256) -> rows
    "aux_tbl": 0,     # flat match + indirect arena
    "d12": 0,         # (256 + 65536 + 512, 256)
    "ppm": 1,         # (NP, PR, 64) -> rows
    "sbank": 1,       # (NS, R, 256) -> rows
}


def make_mesh(n_dp, n_tp=1):
    """The (dp, tp) mesh over the process group's ranks (one process, no
    group: 1 x 1)."""
    return global_mesh(n_dp, n_tp)


def _tp_rows(cfg: EngineConfig, g: Gates):
    """Each tp table's global row count along its split axis."""
    return {"bank": cfg.rows, "sbank": cfg.rows, "ppm": cfg.prows,
            "d12": D12_ROWS,
            "aux_tbl": g.mstride * g.n_match * (1 << cfg.mbits)
            + g.n_ind * (1 << cfg.ibits)}


def shared_shardings(sh):
    """The split axis of every shared leaf (a tree like ``sh``): the tp
    axis of the ``_SH_TP`` tables, None (replicated) elsewhere."""
    return {k: shared_shardings(v) if isinstance(v, dict) else _SH_TP.get(k)
            for k, v in sh.items()}


def perblock_shardings(pb):
    """The split axis of every per-block leaf: 0, the lanes, over dp."""
    return {k: perblock_shardings(v) if isinstance(v, dict) else 0
            for k, v in pb.items()}


def shard_state(sh, n_tp, tp_rank):
    """A whole shared state -> tp rank ``tp_rank``'s: its rows of each tp
    table (a contiguous copy), every other leaf as it is."""
    out = {}
    for k, v in sh.items():
        axis = _SH_TP.get(k)
        if axis is None:
            out[k] = v
        else:
            lo, hi = host_block_span(v.shape[axis], n_tp, tp_rank)
            out[k] = v.narrow(axis, lo, hi - lo).clone()
    return out


def unshard_state(shards):
    """The shared states of tp ranks 0..n_tp-1, in order -> the whole
    state (the tp tables concatenated; the other leaves rank 0's)."""
    return {k: torch.cat([s[k] for s in shards], dim=_SH_TP[k])
            if k in _SH_TP else v for k, v in shards[0].items()}


def sharded_group_state(cfg: EngineConfig, g: Gates, b, mesh: Mesh, device):
    """(sh, pb) of a fresh coding group of ``b`` lanes on this rank: its
    tp slices of the shared state and its dp lanes' positional state."""
    if b % mesh.n_dp:
        raise ValueError(f"{b} lanes do not split over dp={mesh.n_dp}")
    sh = shard_state(init_shared(cfg, g, device), mesh.n_tp, mesh.tp_rank)
    return sh, init_perblock(cfg, g, b // mesh.n_dp, device)


def state_digests(sh):
    """sha256 of every leaf of a state tree, by dotted key (the replicas'
    check: equal digests on every rank that holds the leaf)."""
    out = {}

    def walk(tree, pre):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.")
            else:
                a = v.detach().cpu().reshape(-1).view(torch.uint8)
                out[pre + k] = hashlib.sha256(a.numpy().tobytes()).hexdigest()
    walk(sh, "")
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []                                       # None


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


class ShardComm:
    """The collectives of one rank's byte step (``engine.make_byte_step``'s
    ``comm``).  ``start(b)`` begins a coding group of b lanes: the rank's
    lanes start at ``lane0``, and ``hist`` holds every lane's history (one
    buffer per group width, zeroed in place, so a graph captured at a width
    keeps reading it).  ``counts`` totals the bytes this rank sends into
    all-gathers and all-reduces and the calls of each (a graph adds a
    replay's at each replay)."""

    def __init__(self, cfg: EngineConfig, g: Gates, mesh: Mesh, device):
        self.mesh, self.device = mesh, device
        self.block_size = cfg.block_size
        self.n_rows = _tp_rows(cfg, g)
        self.span = {k: host_block_span(n, mesh.n_tp, mesh.tp_rank)
                     for k, n in self.n_rows.items()}
        self.n_lanes = self.lane0 = 0
        self.hist, self._hists = None, {}
        self.counts = dict(gather_bytes=0, gathers=0, reduce_bytes=0,
                           reduces=0)

    @property
    def capturable(self):
        """Whether a CUDA graph can capture the step's collectives: not
        under Gloo, whose collectives stage through host memory."""
        return self.mesh.backend != "gloo"

    def start(self, b):
        self.n_lanes = b
        self.lane0 = self.mesh.dp_rank * (b // self.mesh.n_dp)
        if b not in self._hists:
            self._hists[b] = torch.zeros((b, self.block_size),
                                         dtype=torch.uint8,
                                         device=self.device)
        self.hist = self._hists[b].zero_()

    def own_lanes(self, tree):
        """The rank's lanes of a tree of every lane's tensors."""
        n = self.n_lanes // self.mesh.n_dp
        return _rebuild(tree, iter(x[self.lane0:self.lane0 + n]
                                   for x in _leaves(tree)))

    def lanes(self, tree):
        """Every lane's tensors, in lane order, from the rank's lanes of a
        tree (dicts, lists, tuples, None) of tensors with the lanes first:
        one all-gather over dp of the leaves packed as bytes."""
        mesh = self.mesh
        leaves = _leaves(tree)
        if mesh.dp_group is None:
            return tree
        n = leaves[0].shape[0]
        cols = [x.reshape(n, -1).contiguous().view(torch.uint8)
                for x in leaves]
        buf = torch.cat(cols, dim=1)
        self.counts["gather_bytes"] += buf.numel()
        self.counts["gathers"] += 1
        full = mesh.all_gather(buf, mesh.dp_group)
        out, at = [], 0
        for x, c in zip(leaves, cols):
            w = c.shape[1]
            out.append(full[:, at:at + w].contiguous().view(x.dtype)
                       .reshape((full.shape[0],) + tuple(x.shape[1:])))
            at += w
        return _rebuild(tree, iter(out))

    def rows(self, key, tbl, idx, lead=None):
        """``table[lead, idx]`` (``table[idx]`` without ``lead``) of the
        whole tp table ``key`` from this rank's slice ``tbl``: its own
        rows gathered, the others zero, summed over tp."""
        mesh = self.mesh
        if mesh.tp_group is None:
            return tbl[idx] if lead is None else tbl[lead, idx]
        lo, hi = self.span[key]
        own = (idx >= lo) & (idx < hi)
        li = torch.where(own, idx - lo, 0)
        v = tbl[li] if lead is None else tbl[lead, li]
        v = torch.where(own.view(own.shape + (1,) * (v.dim() - own.dim())),
                        v, 0)
        self.counts["reduce_bytes"] += v.numel() * v.element_size()
        self.counts["reduces"] += 1
        return mesh.all_reduce(v, mesh.tp_group)

    def set_rows(self, key, tbl2d, flat, vals):
        """``table2d[flat] = vals`` on this rank's rows: ``flat`` indexes
        the whole table's 2-d view (duplicates already resolved), tbl2d is
        the rank's slice's view.  The write has the shape of ``flat`` on
        every rank (``engine._masked_rows``), with no collective."""
        if self.mesh.tp_group is None:
            tbl2d[flat] = vals
            return
        lo, hi = self.span[key]
        if _SH_TP[key] == 0:
            r, local = flat, flat - lo
        else:
            n = self.n_rows[key]
            r = flat % n
            local = (flat // n) * (hi - lo) + r - lo
        f, v = _masked_rows(tbl2d, local, vals, (r >= lo) & (r < hi))
        tbl2d[f] = v


def make_sharded_transcoder(cfg: EngineConfig, g: Gates, mesh: Mesh,
                            device="cuda", graph=None):
    """``transcode(sh, pb, inp, comp, mode, meter=None) -> (hist, out,
    out_len)``, the contract of ``engine.make_transcoder``, on this rank
    of ``mesh``.

    Every rank receives the whole group's inputs (inp (B, N), comp (B, C),
    mode scalar or (B,)) and its own state (``sharded_group_state``: its tp
    slices and its dp lanes' ``pb``).  It codes its lanes through
    ``engine.make_transcoder``'s segment pipeline and returns every block,
    in block order (the ordered gather over dp).  ``graph``: None replays
    the byte step as a CUDA graph, collectives included, on the card under
    NCCL or without a process group, and runs it eagerly under Gloo (whose
    collectives cannot be captured; True raises ValueError there) or on the
    CPU.  Runs on the card unless the caller asks for the CPU.
    ``transcode.comm`` is the step's ``ShardComm``, ``transcode.graph``
    whether it replays a graph, ``transcode.state()`` this rank's (sh, pb,
    cd) after the last group (a later group's state lives in the graph's
    buffers, not in the arrays handed in)."""
    device = resolve_device(device)
    comm = ShardComm(cfg, g, mesh, device)
    if graph is None:
        graph = comm.capturable
    lanes = make_transcoder(cfg, g, device, graph=graph, comm=comm)
    gather = make_ordered_gather(mesh)

    def transcode(sh, pb, inp, comp, mode, meter=None):
        b = int(inp.shape[0])
        if b % mesh.n_dp:
            raise ValueError(f"{b} lanes do not split over dp={mesh.n_dp}")
        comm.start(b)
        lo, hi = comm.lane0, comm.lane0 + b // mesh.n_dp
        mode = np.broadcast_to(np.asarray(mode, dtype=np.int64), (b,))
        _, out, out_len = lanes(sh, pb, np.asarray(inp)[lo:hi],
                                np.asarray(comp)[lo:hi], mode[lo:hi], meter)
        out_len, pay = gather(out_len, out)
        out = np.zeros((b, cfg.comp_size), dtype=np.uint8)
        n = min(pay.shape[1], cfg.comp_size)
        out[:, :n] = pay[:, :n]
        return comm.hist.cpu().numpy(), out, out_len

    transcode.comm = comm
    transcode.graph = bool(graph) and device.type == "cuda"
    transcode.state = lanes.state
    return transcode
