"""uint32 arithmetic on int64 tensors.

PyTorch's ``uint32`` lacks ``>>``, ``+``, comparisons and ``index_put_`` on
the CPU, so the port represents a u32 value as an int64 tensor holding
0..2^32-1 while computing (shifts are then logical, comparisons unsigned)
and masks after every operation that can carry past bit 31.  Large tables
stay at rest as int32 holding the same 32 bits (``to_bits``/``from_bits``),
so they take the memory the JAX package's uint32 tables take.

Products are split into 16-bit halves so that no int64 intermediate can
overflow: every operation here is defined, on any device.
"""

import torch

M32 = 0xFFFFFFFF
PHI32 = 0x9E3779B1
PRIME2 = 0x85EBCA77


def from_bits(x):
    """int32 (or any int) tensor of u32 bits -> int64 u32 values."""
    return x.long() & M32


def to_bits(x):
    """int64 u32 values -> int32 tensor with the same 32 bits."""
    x = x & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul(a, b):
    """(a * b) mod 2^32 for u32 values (tensors or Python ints)."""
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def add(a, b):
    return (a + b) & M32


def sub(a, b):
    return (a - b) & M32


def shl(a, k):
    return (a << k) & M32


def mix32(h, x):
    """uint32 hash combine (format constant; cmix_tpu.contexts.hashes)."""
    h = mul(h ^ x, PHI32)
    return h ^ (h >> 15)
