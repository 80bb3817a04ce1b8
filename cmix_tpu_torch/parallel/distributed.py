"""Multi-process execution on torch.distributed: process init, the dp x tp
mesh, block spans, the ordered gather of variable-length streams and the
state broadcast.

Port of cmix_tpu/parallel/distributed.py.  JAX runs one process per host
and places arrays on a device mesh; here one process runs per rank (one
rank per device), and the mesh is a set of process groups: the ranks are
laid out dp-major over ("dp", "tp"), so rank r sits at
``divmod(r, n_tp)`` and consecutive dp ranks own consecutive blocks.

* **Block ownership** is static: dp rank d owns blocks [d*B/dp,
  (d+1)*B/dp).  The archive's block table keeps block order, so the
  gather concatenates per-rank results in rank order.
* **Variable-length gather**: the compressed lengths are all-gathered
  over dp first (a fixed-size int vector), then the payloads padded to
  the group's longest, then trimmed on the host.
* **State broadcast**: rank 0's tensors are sent to every rank
  (``dist.broadcast``), the pretrained shared state for one.

Collectives run where the group's backend takes them (``Mesh.stage``):
under NCCL on the card (a CPU tensor is copied there and back), under Gloo
on the host (a CUDA tensor is copied to pinned host memory and back), so
that ranks which share one card run under Gloo.  Under NCCL a CUDA
tensor's collectives read nothing back to the host and gather into one
output (``all_gather_into_tensor``), so a CUDA graph can capture them.
"""

import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     backend=None):
    """Join the process group of ``num_processes`` ranks over
    ``tcp://coordinator`` (host:port) as rank ``process_id`` -> (world
    size, rank).  ``backend`` defaults to NCCL where CUDA is available and
    Gloo elsewhere.  A no-op returning the current group's numbers (1, 0
    without one) for a single process that names no coordinator."""
    if num_processes is not None and not dist.is_initialized() and (
            num_processes > 1 or coordinator is not None):
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True)
class Mesh:
    """The ("dp", "tp") mesh as seen by one rank: its place and the groups
    of its row (``tp_group``: the ranks of its dp index) and of its column
    (``dp_group``: the ranks of its tp index).  Without a process group
    (one process, a 1 x 1 mesh) both groups are None and every collective
    is the identity."""
    n_dp: int
    n_tp: int
    rank: int
    dp_group: object = None
    tp_group: object = None
    axis_names = ("dp", "tp")

    @property
    def shape(self):
        return (self.n_dp, self.n_tp)

    @property
    def dp_rank(self):
        return self.rank // self.n_tp

    @property
    def tp_rank(self):
        return self.rank % self.n_tp

    @property
    def backend(self):
        return dist.get_backend() if dist.is_initialized() else None

    def _on_backend(self, x):
        """``x`` where the group's backend takes it: a CUDA tensor under
        Gloo as a pinned host copy, a CPU tensor under NCCL as a copy on
        the current card, else ``x`` itself."""
        if x.is_cuda and self.backend == "gloo":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return host.copy_(x)
        if not x.is_cuda and self.backend == "nccl":
            return x.cuda()
        return x.contiguous()

    def stage(self, x, fn):
        """Run the in-place collective ``fn`` on ``x`` where its backend
        takes it (``_on_backend``; a copy's result is copied back into
        ``x``); -> x."""
        y = self._on_backend(x)
        fn(y)
        if y is not x:
            x.copy_(y)
        return x

    def all_gather(self, x, group):
        """The tensors ``x`` of the group's ranks concatenated on dim 0 in
        rank order, on x's device (the identity without a group)."""
        if group is None:
            return x
        src = self._on_backend(x)
        n = dist.get_world_size(group)
        if self.backend == "nccl":
            out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=group)
            return out.to(x.device)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=0).to(x.device)

    def all_reduce(self, x, group):
        """Sum of ``x`` over the group, in place (the identity without a
        group); -> x."""
        if group is None:
            return x
        return self.stage(x, lambda h: dist.all_reduce(h, group=group))


def global_mesh(n_dp=None, n_tp=1):
    """The mesh over every rank of the process group, dp-major: rank r is
    (dp, tp) = divmod(r, n_tp).  Every rank must call it (it creates the
    groups of every row and column, in one order)."""
    world, rank = init_distributed()
    if n_dp is None:
        n_dp = world // n_tp
    if n_dp * n_tp != world:
        raise ValueError(f"mesh {n_dp} x {n_tp} needs {n_dp * n_tp} ranks; "
                         f"the process group has {world}")
    if not dist.is_initialized():
        return Mesh(n_dp, n_tp, rank)
    dp_group = tp_group = None
    for p in range(n_tp):
        grp = dist.new_group([d * n_tp + p for d in range(n_dp)])
        if rank % n_tp == p:
            dp_group = grp
    for d in range(n_dp):
        grp = dist.new_group([d * n_tp + p for p in range(n_tp)])
        if rank // n_tp == d:
            tp_group = grp
    return Mesh(n_dp, n_tp, rank, dp_group, tp_group)


def host_block_span(n_blocks: int, world=None, rank=None):
    """[lo, hi) of the block indices rank ``rank`` of ``world`` owns (the
    process group's by default): static ownership, ceil(n / world) each
    (the split of the tp tables' rows too)."""
    if world is None:
        world, rank = init_distributed()
    per = -(-n_blocks // world)
    return min(rank * per, n_blocks), min((rank + 1) * per, n_blocks)


def make_ordered_gather(mesh: Mesh):
    """-> gather(lens, payload) -> (all_lens, all_payload) as numpy arrays:
    the dp ranks' int lengths (B_local,) and uint8 payloads (B_local, cap)
    in rank order, hence block order.  The lengths go first; the payloads
    are padded to the group's longest, all-gathered, and trimmed to it."""

    def gather(lens, payload):
        lens = torch.as_tensor(np.asarray(lens, dtype=np.int64))
        payload = torch.as_tensor(np.asarray(payload, dtype=np.uint8))
        all_lens = mesh.all_gather(lens, mesh.dp_group)
        width = int(all_lens.max()) if all_lens.numel() else 0
        pad = torch.zeros((payload.shape[0], width), dtype=torch.uint8)
        n = min(width, payload.shape[1])
        pad[:, :n] = payload[:, :n]
        return (all_lens.numpy(),
                mesh.all_gather(pad, mesh.dp_group).numpy())

    return gather


def broadcast_state(state, mesh: Mesh):
    """Every tensor of the state tree (dicts of tensors) sent from rank 0
    to every rank, in place; -> state.  Call it with tensors of the same
    shapes and types on every rank."""
    for v in state.values():
        if isinstance(v, dict):
            broadcast_state(v, mesh)
        elif dist.is_initialized():
            mesh.stage(v, lambda h: dist.broadcast(h, src=0))
    return state


def gather_streams(mesh, out, out_len):
    """(out uint8 (B_local, cap), out_len (B_local,)) -> the streams of
    every block, in block order, as a list of bytes."""
    lens, payload = make_ordered_gather(mesh)(out_len, out)
    return [payload[i, :lens[i]].tobytes() for i in range(len(lens))]
