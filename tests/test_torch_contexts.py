"""Port's per-byte context state (rolling hashes, words, classes, brackets,
line/cell grids) and x86 decoder state vs the JAX package, fed the same
text and x86 bytes at B=4.  All u32 integer arithmetic: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cmix_tpu.contexts import hashes as jh
from cmix_tpu.contexts import x86 as jx
from cmix_tpu_torch.contexts import hashes, x86

CPU = torch.device("cpu")
B = 4


def _lanes(n):
    """Two text lanes and two x86 lanes of n bytes each."""
    text = open("testdata/text100k.raw", "rb").read()
    exe = open("testdata/exe100k.raw", "rb").read()
    rows = [text[:n], text[50000:50000 + n], exe[4096:4096 + n],
            exe[60000:60000 + n]]
    return np.stack([np.frombuffer(r, np.uint8) for r in rows])


def _tile(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.tile(x[None], (B,) + (1,) * x.ndim), tree)


def _same(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        a = port[k].numpy()
        b = np.asarray(ref[k]).astype(np.int64)
        assert np.array_equal(a, b), k


def test_ctx_and_x86_state_match_jax_over_text_and_exe():
    data = _lanes(1200)
    ctx_j, x86_j = _tile(jh.init_ctx_state()), _tile(jx.init_x86_state())
    ctx_t, x86_t = hashes.init_ctx_state(B, CPU), x86.init_x86_state(B, CPU)
    _same(ctx_t, ctx_j)
    _same(x86_t, x86_j)

    @jax.jit
    def step_j(c, s, b):
        return jh.update_ctx_state_batched(c, b), jx.x86_update(s, b)

    @jax.jit
    def derived_j(c, s):
        v, gate = jx.x86_ctx_vals(s)
        exp, alive = jh.line_expected(c)
        return jh.bracket_ctx(c), exp, alive, v, gate

    for t in range(data.shape[1]):
        b = data[:, t]
        ctx_j, x86_j = step_j(ctx_j, x86_j, jnp.asarray(b.astype(np.uint32)))
        bt = torch.as_tensor(b.astype(np.int64))
        ctx_t = hashes.update_ctx_state_batched(ctx_t, bt)
        x86_t = x86.x86_update(x86_t, bt)
        if t % 100 == 99:
            _same(ctx_t, jax.device_get(ctx_j))
            _same(x86_t, jax.device_get(x86_j))
            brk, exp, alive, v, gate = jax.device_get(derived_j(ctx_j,
                                                                x86_j))
            exp_t, alive_t = hashes.line_expected(ctx_t)
            v_t, gate_t = x86.x86_ctx_vals(x86_t)
            assert np.array_equal(hashes.bracket_ctx(ctx_t).numpy(), brk)
            assert np.array_equal(exp_t.numpy(), exp)
            assert np.array_equal(alive_t.numpy(), alive)
            assert np.array_equal(v_t.numpy(), v)
            assert np.array_equal(gate_t.numpy(), gate)
    # the x86 lanes really decoded instructions, the text lanes words
    assert int(x86_t["op"][2:].max()) > 0 and int(ctx_t["word"][:2].max())


def test_byte_tables_match():
    for name in ("BYTE_CLASS", "LOWER_MAP", "IS_LETTER", "BR_OPEN",
                 "BR_CLOSE", "CLS2", "IS_SENT_END"):
        assert np.array_equal(getattr(hashes, name),
                              np.asarray(getattr(jh, name))), name
    # the port packs the six x86 opcode tables into one word per byte
    t = [np.asarray(getattr(jx, n)).astype(np.int64) for n in (
        "IS_PREFIX", "MODRM1", "IMM1", "MODRM2", "IMM2", "ISJMP1")]
    packed = t[0] | (t[1] << 1) | (t[2] << 2) | (t[3] << 5) | (t[4] << 6) \
        | (t[5] << 9)
    assert np.array_equal(np.asarray(x86.X86_LUT).astype(np.int64), packed)


def test_x86_ext_vals_match_jax_over_exe():
    # the X86X contexts (opcode bigram and history hash; trigram and ModRM
    # reg field) over four lanes of x86 code
    exe = open("testdata/exe100k.raw", "rb").read()
    n = 600
    data = np.stack([np.frombuffer(exe[o:o + n], np.uint8)
                     for o in (4096, 36864, 60000, 90000)])
    x86_j, x86_t = _tile(jx.init_x86_state()), x86.init_x86_state(B, CPU)

    @jax.jit
    def step_j(s, b):
        s = jx.x86_update(s, b)
        return s, jx.x86_ext_vals(s), jx.x86_ext_vals2(s)

    seen = set()
    for t in range(n):
        b = data[:, t]
        x86_j, v1, v2 = step_j(x86_j, jnp.asarray(b.astype(np.uint32)))
        x86_t = x86.x86_update(x86_t, torch.as_tensor(b.astype(np.int64)))
        got1, got2 = x86.x86_ext_vals(x86_t), x86.x86_ext_vals2(x86_t)
        assert np.array_equal(got1.numpy(), np.asarray(v1)), t
        assert np.array_equal(got2.numpy(), np.asarray(v2)), t
        seen.update(got2[:, 1].tolist())
    assert len(seen) > 50                    # many distinct (op, reg, phase)
