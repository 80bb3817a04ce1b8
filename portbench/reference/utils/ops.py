"""Float scans in a fixed, portable summation order.

Encode and decode must compute identical predictions, and the CPU tests
hold the port against the JAX package bit for bit where they can.  Both
ask for float cumulative sums whose rounding does not depend on the
device or library: PyTorch's CPU ``cumsum``/``cumprod`` accumulate float32
in double, and a product with a triangular matrix sums in whatever order
the BLAS picks.

So the scans here are written out as float32 adds (products) in the order
XLA's CPU backend uses for ``jnp.cumsum``/``jnp.cumprod`` (measured: a
sequential scan up to 16 elements; a 256-long scan as 16 blocks of 16,
each scanned sequentially, plus the sequential exclusive scan of the block
totals).  Every step is one IEEE float32 operation, so the result is the
same on the CPU and the GPU, run after run.
"""

import torch

_BLOCK = 16


def _scan_seq(x, op):
    acc = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        acc.append(op(acc[-1], x[..., i]))
    return torch.stack(acc, dim=-1)


def cumsum_last(x):
    """Inclusive float32 cumulative sum over the last axis (n <= 16, or
    16 k with k <= 16)."""
    n = x.shape[-1]
    if n <= _BLOCK:
        return _scan_seq(x, torch.add)
    nb = n // _BLOCK
    if n % _BLOCK or nb > _BLOCK:
        raise ValueError(f"cumsum length {n} has no XLA-order twin here")
    inner = _scan_seq(x.reshape(x.shape[:-1] + (nb, _BLOCK)), torch.add)
    tot = _scan_seq(inner[..., -1], torch.add)
    pre = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], dim=-1)
    return (inner + pre[..., None]).reshape(x.shape)


def cumprod_last(x):
    """Inclusive float32 cumulative product over the last axis (n <= 16)."""
    if x.shape[-1] > _BLOCK:
        raise ValueError(f"cumprod length {x.shape[-1]} > {_BLOCK}")
    return _scan_seq(x, torch.mul)


def cumsum0_last(x):
    """Exclusive-prefix form used by the interval reads: [0, cumsum(x)]."""
    return torch.cat([torch.zeros_like(x[..., :1]), cumsum_last(x)], dim=-1)
