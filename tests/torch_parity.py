"""Shared helpers of the port's parity tests (JAX package vs cmix_tpu_torch).

Not a test module: the test files import it (pytest puts tests/ on the path).
"""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmix_tpu.models import dmc as jdmc
from cmix_tpu_torch import convert
from cmix_tpu_torch.models import dmc

# the parity tests run tiny tensors: threads only add overhead, and the
# suite runs several worker processes side by side
torch.set_num_threads(1)

B, N = 4, 5120                           # whole-tile pool for the Pallas path


@pytest.fixture
def jax_levels():
    old = jdmc.DMC_LEVELS

    def set_levels(levels):
        jdmc.DMC_LEVELS = levels
    yield set_levels
    jdmc.DMC_LEVELS = old


def dmc_to_port(pb):
    return convert.from_jax_state({}, jax.device_get(pb), {},
                                  device="cpu")[1]


def u32_np(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def jax_dmc_state(seed, steps):
    """Grown machines with real pending descriptors (JAX deferred flow)."""
    pb = {k: jnp.tile(v[None], (B,) + (1,) * v.ndim)
          for k, v in jdmc.init_dmc_perblock(N).items()}
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        upd, walk = jdmc.predict_step(pb)
        pb.update(upd)
        pb.update(jdmc.plan_step({k: pb[k] for k in jdmc.DMC_KEYS}, walk,
                                 jnp.asarray(rng.randint(0, 256, size=B))))
    return pb


def check_against_pallas(levels, jax_levels):
    """The TPU kernel itself, interpreted (slow: two of the four blocks)."""
    jax_levels(levels)
    pb = jax_dmc_state(levels, 60)
    upd, walk = dmc.predict_step(dmc_to_port(pb), levels)
    got = [upd["dmc_nxt"], upd["dmc_cnt"], walk["cw"], walk["vis"],
           walk["wn"]]
    two = {k: v[:2] for k, v in pb.items()}
    ker = jdmc._fused_pallas(
        two["dmc_nxt"], two["dmc_cnt"], two["dmc_cur"], two["dmc_uX"],
        two["dmc_uXC"], two["dmc_uS"], two["dmc_uSW"], two["dmc_uU"],
        two["dmc_uUW"], interpret=True, levels=levels)
    for g, k in zip(got, ker):
        assert np.array_equal(u32_np(g[:2]), u32_np(k))


# ---- the runner: archives of the two packages side by side

RUNNER_KW = dict(block_size=64, seg_size=64, tbits=12, mbits=12, ibits=10,
                 pbits=12, lstm_hidden=32, dmc_nodes=4096, lstm_horizon=4)
# archive size: the port against the JAX package at equal config; the f32
# sums run in another order, so predictions may drift apart after some
# hundred bytes -- the coded size must stay within 1%
SIZE_TOL = 0.01


def check_runner_against_jax(env):
    """compress 5 text blocks with both packages at exec batch 3 (the
    second group padded with a dummy lane) -> the same header, gate record
    and length-table flags, coded size within SIZE_TOL; the port's archive
    decodes exactly.  Returns the relative size gap."""
    import struct
    from cmix_tpu import engine as je
    from cmix_tpu import runner as jr
    from cmix_tpu_torch import engine as te
    from cmix_tpu_torch import runner as tr
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[1000:1320]
    with jax_runner_gates(env):
        aj = jr.compress(data, je.EngineConfig(**RUNNER_KW), max_batch=3)
    at = tr.compress(data, te.EngineConfig(**RUNNER_KW), max_batch=3,
                     gates=env, device="cpu")
    off = 4 + tr._HDR_LEN
    glen = struct.unpack("<H", at[off:off + 2])[0]
    end = off + 2 + glen
    assert at[:end] == aj[:end]                 # header + gate record
    assert at[off + 2:end] == te.make_gates(env).blob()
    assert at[5] == 0                           # flags: no segment table
    lens_t = struct.unpack("<5I", at[end:end + 20])
    lens_j = struct.unpack("<5I", aj[end:end + 20])
    assert [L >> 31 for L in lens_t] == [L >> 31 for L in lens_j]
    gap = (len(at) - len(aj)) / len(aj)
    assert abs(gap) <= SIZE_TOL, (len(at), len(aj))
    assert tr.decompress(at, device="cpu") == data
    return gap


def archive_sizes(env, nbytes, block):
    """(JAX package archive bytes, port archive bytes) for the first
    ``nbytes`` of text100k.raw at RUNNER_KW's widths, ``block``-byte blocks,
    both on the CPU."""
    from cmix_tpu import engine as je
    from cmix_tpu import runner as jr
    from cmix_tpu_torch import engine as te
    from cmix_tpu_torch import runner as tr
    kw = dict(RUNNER_KW, block_size=block, seg_size=min(block, 256))
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[:nbytes]
    with jax_runner_gates(env):
        aj = jr.compress(data, je.EngineConfig(**kw))
    at = tr.compress(data, te.EngineConfig(**kw), gates=env, device="cpu")
    return len(aj), len(at)


# ---- the portable profile: the JAX package's archives, PORT=1


@contextlib.contextmanager
def jax_runner_gates(env):
    """``cmix_tpu.runner`` with ``env``'s gates live; the process's gates
    are restored after, and the transcoder cache (keyed by the config
    alone, with the gates baked in at trace time) is dropped both ways."""
    from cmix_tpu import engine as je
    from cmix_tpu import runner as jr
    prev = je.gates_blob()
    je.update_gates(env)
    jr._TRANSCODER_CACHE.clear()
    try:
        yield jr
    finally:
        je.apply_gates(prev)
        jr._TRANSCODER_CACHE.clear()


def port_fixture():
    """(input bytes, the JAX package's PORT=1 archive of it) for the
    committed fixture that chip_smoke.py decodes and re-encodes."""
    import chip_smoke
    from cmix_tpu import engine as je
    with open(chip_smoke.PORT_FIXTURE, "rb") as f:
        data = f.read()
    with jax_runner_gates({"PORT": 1}) as jr:
        arc = jr.compress(data, je.EngineConfig(**chip_smoke.PORT_SMALL),
                          max_batch=chip_smoke.PORT_BATCH)
    return data, arc


if __name__ == "__main__" and sys.argv[1:] == ["--write-fixture"]:
    # python tests/torch_parity.py --write-fixture: (re)write the portable
    # fixture's archive with the JAX package on the CPU
    import chip_smoke
    _, arc = port_fixture()
    with open(chip_smoke.PORT_ARCHIVE, "wb") as f:
        f.write(arc)
    print(f"{chip_smoke.PORT_ARCHIVE}: {len(arc)} bytes")
elif __name__ == "__main__":
    # python tests/torch_parity.py [nbytes] [block]: the archive size gap
    # between the port and the JAX package on the CPU, both gate sets
    from cmix_tpu_torch.engine import BENCH_GATES
    nbytes = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    block = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    for name, env in (("default", {}), ("bench", BENCH_GATES)):
        lj, lt = archive_sizes(env, nbytes, block)
        print(f"{name} gates, {nbytes} B of text100k.raw, {block} B blocks:"
              f" jax {lj} B ({8 * lj / nbytes:.4f} bpb), port {lt} B "
              f"({8 * lt / nbytes:.4f} bpb), gap {(lt - lj) / lj:+.4%}")
