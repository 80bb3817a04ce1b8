"""Gather-free integer transcendentals and exact integer contractions:
the portable profile's (PORT=1) math substrate.

Copy of cmix_tpu/utils/intmath.py as tensor code (the port imports nothing
of the JAX package).  Portable archives must decode bit-exactly on another
device, so every operation that feeds the coder is integer: add, mul,
shift and floor division are exactly specified on every backend, and
integer sums are associative.  stretch (256*ln(p/(1-p))) and squash (its
inverse) are binary-search floor-log2, fixed-point polynomials for
log2(1+u) and 2^u, and integer division -- the same frozen format constants
as the JAX package.

Domains (the engine's packed slot fields):
  p12:  probability in [1, 4095], p = p12/4096
  st13: stretch in [1024, 7168] = round(256*ln(p/(1-p))) + 4096
  p16:  coder probability in [64, 65472]

The tensor functions take int32 tensors and return int32, as the JAX
package's do; their intermediates stay inside int32 except where noted
(``squash16``'s 2^32-scale numerator runs in int64).

``ieinsum`` stands in for every int32 ``jnp.einsum`` of the profile; see
its note for the exactness bound.
"""

import numpy as np
import torch

ST13_BIAS = 4096
ST13_MIN, ST13_MAX = 1024, 7168          # +-12.0 in ln units * 256
_LOG2_C1, _LOG2_C2, _LOG2_C3 = 46559, -18915, 5124
_EXP2_C1, _EXP2_C2, _EXP2_C3 = 22804, 7371, 2593
_LN2_256_x16 = 2839                      # round(256*ln2 * 16)
_INV_LN2_256 = 2955                      # round(2^19 / (256*ln2))


def _floor_log2(x):
    """Elementwise floor(log2(x)) for integer x >= 1 (< 2^24)."""
    e = torch.zeros_like(x)
    for k in (16, 8, 4, 2, 1):
        big = x >= (1 << k)
        e = e + torch.where(big, k, 0).to(e.dtype)
        x = torch.where(big, x >> k, x)
    return e


def log2_fix15(x):
    """Elementwise log2(x) in 15-bit fixed point, x int32 in [1, 2^16)."""
    e = _floor_log2(x)
    m = x << (15 - e)                    # mantissa in [2^15, 2^16)
    u = m - (1 << 15)                    # frac in [0, 2^15)
    h = (_LOG2_C3 * u) >> 15
    h = ((h + _LOG2_C2) * u) >> 15
    h = ((h + _LOG2_C1) * u) >> 15
    return (e << 15) + h


def stretch13_from_p12(p12):
    """p12 [1,4095] -> st13 [1024,7168] (int32)."""
    a = 2 * p12 + 1                      # center of the p12 bucket, /8192
    b = 2 * (4096 - p12) - 1
    ld = log2_fix15(a) - log2_fix15(b)   # log2(p/(1-p)), 15-bit frac
    st = ST13_BIAS + (((ld >> 4) * _LN2_256_x16) >> 15)
    return torch.clamp(st, ST13_MIN, ST13_MAX)


def _exp2_parts(st13x):
    """For x = st13 - 4096 (+-3072): returns (z, k) with
    2^(x/(256 ln2)) = z * 2^(k-15), z in [2^15, 2^16)."""
    y = (st13x * _INV_LN2_256) >> 4      # log2-domain, 15-bit frac
    k = y >> 15                          # floor toward -inf (arith shift)
    g = y - (k << 15)                    # frac in [0, 2^15)
    h = (_EXP2_C3 * g) >> 15
    h = ((h + _EXP2_C2) * g) >> 15
    h = ((h + _EXP2_C1) * g) >> 15
    return (1 << 15) + h, k


def _shift_parts(st13):
    st13 = torch.clamp(st13, ST13_MIN, ST13_MAX)
    z, k = _exp2_parts(st13 - ST13_BIAS)
    sh = 15 - k                          # in [-2, 33]
    shc = torch.clamp(sh, 0, 30)
    return z, sh, torch.ones_like(shc) << shc


def squash16(st13):
    """st13 -> p16 in [64, 65472] (int32)."""
    z, sh, one = _shift_parts(st13)
    z64 = z.long()
    p16 = ((z64 << 16) // (z64 + one.long())).to(z.dtype)   # u32 numerator
    p16 = torch.where(sh > 30, 0, p16)   # p below representable floor
    return torch.clamp(p16, 64, 65472)


def squash12(st13):
    """st13 -> p12 in [1, 4095] (int32)."""
    z, sh, one = _shift_parts(st13)
    p12 = (z << 12) // (z + one)
    p12 = torch.where(sh > 30, 0, p12)
    return torch.clamp(p12, 1, 4095)


# ------------------------------------------------------ table lookups
#
# The gather-free forms above exist because dynamic gathers are slow on a
# TPU.  The port's eager step is bound by the host's per-operator cost
# instead, and each call above is ~60 small operators, so the engine
# reads the same functions from tables computed by them at first use on
# each device: one gather each, and equal by construction.

_LUTS = {}


def _lut(fn, lo, hi, device):
    key = (fn.__name__, str(device))
    if key not in _LUTS:
        _LUTS[key] = fn(torch.arange(lo, hi + 1, dtype=torch.int32,
                                     device=device))
    return _LUTS[key]


def stretch13_lut(p12):
    """``stretch13_from_p12`` for p12 in [0, 4096], by table."""
    return _lut(stretch13_from_p12, 0, 4096, p12.device)[p12.long()]


def squash12_lut(st13):
    """``squash12`` of any int32 st13, by table."""
    i = torch.clamp(st13, ST13_MIN, ST13_MAX).long() - ST13_MIN
    return _lut(squash12, ST13_MIN, ST13_MAX, st13.device)[i]


def squash16_lut(st13):
    """``squash16`` of any int32 st13, by table."""
    i = torch.clamp(st13, ST13_MIN, ST13_MAX).long() - ST13_MIN
    return _lut(squash16, ST13_MIN, ST13_MAX, st13.device)[i]


# ---------------------------------------------- exact integer contraction


def wrap32(x):
    """int64 values -> int32 with the same low 32 bits (two's complement):
    what an int32 sum that wraps would hold."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def ieinsum(eq, *ops):
    """``jnp.einsum(eq, *ops)`` on int32 operands, as XLA computes it:
    the exact sum wrapped to int32.

    PyTorch has no integer matmul on CUDA, so the contraction runs in
    float64 (cuBLAS DGEMM on the card, the CPU BLAS here) and is exact
    while every product and partial sum stays below 2^53 in magnitude.
    The profile's operands keep far inside that: the largest are p12
    errors (< 2^12) times st256 inputs (< 2^13) or Q12 activations times
    16-bit weight halves (< 2^12 * 2^11), summed over at most 2^10 terms
    -- below 2^36.  Wrapping the exact sum to int32 gives the bits of
    int32 wrapping accumulation in any order (sums mod 2^32 are
    associative), so the result is the JAX package's, on any device.
    TF32 does not touch float64."""
    out = torch.einsum(eq, *(o.double() for o in ops))
    return wrap32(out.to(torch.int64))


# ----------------------------------------------------- numpy reference twins


def stretch13_np(p12):
    p = (2.0 * np.asarray(p12, np.float64) + 1.0) / 8192.0
    st = np.rint(256.0 * np.log(p / (1.0 - p))) + 4096.0
    return np.clip(st, ST13_MIN, ST13_MAX).astype(np.int64)


def squash16_np(st13):
    x = (np.clip(np.asarray(st13, np.float64), ST13_MIN, ST13_MAX)
         - 4096.0) / 256.0
    return np.clip(np.rint(65536.0 / (1.0 + np.exp(-x))),
                   64, 65472).astype(np.int64)


def squash12_np(st13):
    x = (np.clip(np.asarray(st13, np.float64), ST13_MIN, ST13_MAX)
         - 4096.0) / 256.0
    return np.clip(np.rint(4096.0 / (1.0 + np.exp(-x))),
                   1, 4095).astype(np.int64)
