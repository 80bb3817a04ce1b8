"""The port's WRT codeword tracker (gate WRTW) against the JAX package's
``update_ctx_state_batched`` at B=4, WRTW 0/1/2, fed WRT text of
english.dic (1- and 2-byte codewords, CAP/UPR marks, escaped bytes) and
synthetic streams of 3-byte codewords and escapes; every leaf exact after
every byte.  ``build_wrtw_tables`` equal on english.dic and on a list long
enough for 3-byte ids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmix_tpu.contexts.hashes as jh
from cmix_tpu_torch.contexts import hashes
from cmix_tpu_torch.preprocess import wrt

B, N = 4, 700
DIC = "cmix_tpu_torch/data/english.dic"


def _words():
    """english.dic's words, then synthetic letter words up to 20000 ids, so
    that ids of 3-byte codewords (>= 12352) have table rows."""
    words = [w.lower() for w in wrt.Dictionary(DIC).words]
    rng = np.random.default_rng(7)
    while len(words) < 20000:
        n = int(rng.integers(2, 12))
        words.append("".join(chr(97 + c) for c in rng.integers(0, 26, n)))
    return words


def _lanes():
    """(B, N) uint8: WRT text, WRT upper/capitalized text with escaped
    bytes, 3-byte codewords with escapes, and random bytes."""
    d = wrt.Dictionary(DIC)
    with open("testdata/text100k.raw", "rb") as f:
        text = f.read()
    enc = d.encode(text[:3000])
    caps = d.encode(text[5000:5800].upper() + bytes(range(0x80, 0x100, 3))
                    + b"\x04\x05\x06 The End " + text[6000:6800].title())
    rng = np.random.default_rng(3)
    cw3 = bytearray()
    while len(cw3) < N:
        r = rng.integers(0, 6)
        if r == 0:
            cw3 += bytes([0x04, int(rng.integers(0x80, 0x100))])
        elif r == 1:                              # ids 12352..20000 and above
            cw3 += bytes([0xF0 + int(rng.integers(0, 16)) // 8,
                          int(rng.integers(0, 256)), int(rng.integers(0, 256))])
        elif r == 2:
            cw3 += bytes([0xC0 + int(rng.integers(0, 48)),
                          int(rng.integers(0, 256))])
        elif r == 3:
            cw3.append(0x80 + int(rng.integers(0, 64)))
        else:
            cw3 += b" a "
    rows = [enc, caps, bytes(cw3), rng.integers(0, 256, N, dtype=np.uint8)]
    assert min(len(r) for r in rows) >= N
    return np.stack([np.frombuffer(bytes(r[:N]), np.uint8) for r in rows])


def test_build_wrtw_tables_matches_jax():
    words = _words()
    for got, want in zip(hashes.build_wrtw_tables(words),
                         jh.build_wrtw_tables(words)):
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert hashes.WRTW_TAB_N == jh.WRTW_TAB_N


@pytest.mark.parametrize("wrtw", [0, 1, 2])
def test_tracker_matches_jax(wrtw):
    data = _lanes()
    wt, st = hashes.build_wrtw_tables(_words())
    tab_j = (jnp.asarray(wt), jnp.asarray(st))
    tab_t = (torch.as_tensor(wt.astype(np.int64)),
             torch.as_tensor(st.astype(np.int64)))
    cs_j = jax.tree_util.tree_map(
        lambda x: jnp.tile(x[None], (B,) + (1,) * x.ndim), jh.init_ctx_state())
    cs_t = hashes.init_ctx_state(B, torch.device("cpu"))
    prev = jh.WRTW
    jh.WRTW = wrtw
    try:
        step = jax.jit(lambda c, b, tab: jh.update_ctx_state_batched(
            c, b, wrtw_tab=tab if wrtw >= 2 else None))
        seen = set()
        for t in range(N):
            b = data[:, t]
            cs_j = step(cs_j, jnp.asarray(b.astype(np.uint32)), tab_j)
            cs_t = hashes.update_ctx_state_batched(
                cs_t, torch.as_tensor(b.astype(np.int64)), wrtw, tab_t)
            for k, v in cs_j.items():
                want = np.asarray(v).astype(np.int64)
                assert np.array_equal(cs_t[k].numpy(), want), (k, t)
            seen.update(int(r) for r in cs_t["cwrem"])
    finally:
        jh.WRTW = prev
    # the streams reach every tracker state: idle, 1 and 2 bytes to come,
    # and an escape pending (at WRTW 0 the tracker stays idle)
    assert seen == ({0} if wrtw == 0 else {0, 1, 2, 15})
    if wrtw >= 2:
        assert int(cs_t["cwid"].max()) >= 12352
