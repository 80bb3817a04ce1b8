"""The portable profile's integer substrate in the port against the JAX
package: intmath exhaustively over its domains, the exact integer
contraction against int32 ``jnp.einsum`` (wrapping included), and the
duplicate-scatter winner against ``_claim_win``.  All exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu import engine as je
from cmix_tpu.utils import intmath as jim
from cmix_tpu_torch import engine as E
from cmix_tpu_torch.utils import intmath as im

P12 = np.arange(0, 4097, dtype=np.int32)          # clipped callers included
ST13 = np.arange(0, 8192, dtype=np.int32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("name,dom", [
    ("stretch13_from_p12", np.arange(1, 4096, dtype=np.int32)),
    ("squash16", ST13), ("squash12", ST13),
    ("log2_fix15", np.arange(1, 1 << 16, dtype=np.int32)),
    ("_floor_log2", np.arange(1, 1 << 20, 7, dtype=np.int32))])
def test_intmath_exhaustive(name, dom):
    got = getattr(im, name)(_t(dom))
    assert got.dtype == torch.int32
    ref = np.asarray(getattr(jim, name)(jnp.asarray(dom)))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("lut,fn,dom", [
    ("stretch13_lut", "stretch13_from_p12", np.arange(0, 4097)),
    ("squash12_lut", "squash12", np.arange(-9000, 9000)),
    ("squash16_lut", "squash16", np.arange(-9000, 9000))])
def test_table_forms_equal_the_functions(lut, fn, dom):
    x = _t(dom.astype(np.int32))
    assert torch.equal(getattr(im, lut)(x), getattr(im, fn)(x))


def test_exp2_parts_over_the_stretch_range():
    x = np.arange(-3072, 3073, dtype=np.int32)
    z, k = im._exp2_parts(_t(x))
    zj, kj = jim._exp2_parts(jnp.asarray(x))
    assert np.array_equal(z.numpy(), np.asarray(zj))
    assert np.array_equal(k.numpy(), np.asarray(kj))


def test_numpy_twins_are_copies():
    for name in ("stretch13_np", "squash16_np", "squash12_np"):
        dom = P12[1:-1] if name.startswith("stretch") else ST13
        assert np.array_equal(getattr(im, name)(dom),
                              getattr(jim, name)(dom))


@pytest.mark.parametrize("case", ["random", "saturated", "wraps"])
@pytest.mark.parametrize("eq,sa,sb", [
    ("bmk,bnk->bmn", (4, 9, 256), (4, 40, 256)),
    ("bin,bnk->bik", (4, 6, 40), (4, 40, 256)),
    ("kn,bnk->bk", (256, 40), (4, 40, 256)),
    ("bh,hk->bk", (4, 32), (32, 96))])
def test_ieinsum_matches_int32_einsum(case, eq, sa, sb):
    rng = np.random.default_rng(len(eq) + sa[-1])
    if case == "random":
        a = rng.integers(-4096, 4096, sa, dtype=np.int32)
        b = rng.integers(-3072, 3073, sb, dtype=np.int32)
    elif case == "saturated":
        a = np.full(sa, 4095, np.int32)
        b = np.where(rng.random(sb) < 0.5, -3072, 3072).astype(np.int32)
    else:
        # same-sign operands large enough that the int32 sum wraps
        a = rng.integers(1 << 17, 1 << 18, sa, dtype=np.int32)
        b = rng.integers(1 << 15, 1 << 16, sb, dtype=np.int32)
    ref = np.asarray(jnp.einsum(eq, jnp.asarray(a), jnp.asarray(b)))
    got = im.ieinsum(eq, _t(a), _t(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    if case == "wraps":
        exact = np.einsum(eq, a.astype(np.int64), b.astype(np.int64))
        assert (np.abs(exact) >= 1 << 31).any()


def test_winner_rule_is_claim_win():
    """``_set_rows``'s winner (highest block) marks exactly the entries
    ``_claim_win`` marks, with indices unique within a block and shared
    across blocks."""
    rng = np.random.default_rng(5)
    B, K, n = 16, 6, 40
    fidx = np.stack([rng.choice(n, K, replace=False) for _ in range(B)]
                    ).astype(np.int32)
    want = np.asarray(je._claim_win(n, jnp.asarray(fidx), B))
    flat = _t(fidx.astype(np.int64)).reshape(-1)
    got = (E._winner_pos(flat) == torch.arange(flat.numel())).reshape(B, K)
    assert np.array_equal(got.numpy(), want)
    assert not want.all()                    # collisions were exercised
