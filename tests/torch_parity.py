"""Shared helpers of the port's parity tests (JAX package vs cmix_tpu_torch).

Not a test module: the test files import it (pytest puts tests/ on the path).
"""

import contextlib
import hashlib
import json
import os
import struct
import subprocess
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


# ---- one byte step of the two engines from identical state

STEP_KW = dict(block_size=512, seg_size=256, tbits=12, mbits=12, ibits=10,
               pbits=12, lstm_hidden=32, dmc_nodes=5120, lstm_horizon=4)
# packed slot words whose fields come from a float quantisation: the
# stretch (st13) and probability (p12) fields may round one step apart
# where the f32 inputs differ in the last place; counts/states are exact
_SLOT_TABLES = ("bank", "d12")


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _fields_close(name, a, b):
    a, b = a.astype(np.int64), b.astype(np.int64)
    leaf = name.split(".")[-1]
    if leaf.startswith(_SLOT_TABLES):
        fields = [(a >> 18, b >> 18, 1), ((a >> 6) & 0xFFF,
                                          (b >> 6) & 0xFFF, 1),
                  (a & 0x3F, b & 0x3F, 0)]
    elif leaf == "sbank":
        fields = [(a >> 8, b >> 8, 1), (a & 0xFF, b & 0xFF, 0)]
    else:
        fields = [(a, b, 0)]
    for x, y, tol in fields:
        assert np.abs(x - y).max(initial=0) <= tol, name


@pytest.fixture
def jax_gates():
    """``cmix_tpu.engine.update_gates``, the process's gates restored after."""
    from cmix_tpu import engine as je
    prev = je.gates_blob()
    yield je.update_gates
    je.apply_gates(prev)


def routed_lanes(kind, fields, warm):
    """(4, 200) uint8 lanes and per-block fields for a routed byte step:
    ``exe``: three exe100k.raw lanes and one of text; ``media``: BMP rows,
    WAV samples, text, raw BMP header bytes; ``jpeg``: the routed fixture's
    recoded JPEG (its coefficient planes and its header) and x86 code.
    ``fields="jpeg"``: at step ``warm`` lane 0 is in the JPEG header, lane
    1 in component 1's coefficient plane, lane 2 without JPEG, lane 3 a
    dummy lane's pad."""
    from cmix_tpu_torch.preprocess import wrt
    n = 200
    text = open("testdata/text100k.raw", "rb").read()
    exe = open("testdata/exe100k.raw", "rb").read()
    if kind == "exe":
        rows = [exe[4096:], exe[36864:], text[5000:], exe[60000:]]
    elif kind == "media":
        bmp = open("testdata/media/photo24.bmp", "rb").read()
        wav = open("testdata/media/signal16.wav", "rb").read()
        rows = [bmp[54 + 3000:], wav[44 + 8000:], text[9000:], bmp]
    else:
        with open("testdata/routed.raw", "rb") as f:
            payload, meta = wrt.transform(f.read())
        jpg = sum(e[1] for e in meta[:-1])       # the last entry: JPEGC
        rows = [payload[jpg:], payload[jpg + 700:], exe[36864:],
                payload[jpg + 1000:]]
    data = np.stack([np.frombuffer(r[:n], np.uint8) for r in rows])
    if fields == "jpeg":
        fields = {"jpeg_rel0": [-warm - 200, 600 - warm, -(1 << 31),
                                -(1 << 31) + 1],
                  "jpeg_clen": [[8, 2, 2, 0]] * 2 + [[0] * 4] * 2,
                  "rec_forced": [8, 8, 0, 0], "blk_kind": [7, 7, 2, 0]}
    return data, fields


def step_parity(env, data, fields=None, warm=30, states=False):
    """``warm`` byte steps of the JAX engine on ``data`` ((B, >warm) uint8
    lanes), the state carried to the port (``convert``), then one step of
    both: the coded bits exact; under PORT every leaf exact, else integer
    leaves exact (packed slot fields within one rounding step), float
    leaves within 2e-5 (the LSTM's cumulative distribution x 2^16: 0.05).
    ``fields``: per-block leaves set before the warm-up ({name: array}).
    Returns the port's gates, and with ``states`` the JAX package's shared
    state before and after the compared step (flat numpy leaves)."""
    from cmix_tpu import engine as je
    from cmix_tpu_torch import engine as E
    cpu = torch.device("cpu")
    g = E.make_gates(env)
    assert g.blob() == je.gates_blob()
    b = data.shape[0]
    jcfg, cfg = je.EngineConfig(**STEP_KW), E.EngineConfig(**STEP_KW)
    tile = lambda x: jnp.tile(x[None], (b,) + (1,) * x.ndim)   # noqa: E731
    sh = je.init_shared(jcfg)
    pb = jax.tree_util.tree_map(tile, je.init_perblock(jcfg))
    for k, v in (fields or {}).items():
        pb[k] = jnp.asarray(v, dtype=pb[k].dtype)
    cd = jax.tree_util.tree_map(tile, je.init_coder(jcfg))
    comp = jnp.zeros((b, jcfg.comp_size), jnp.uint8)
    mode = jnp.zeros(b, jnp.int32)
    step_j = jax.jit(je.make_byte_step(jcfg))
    for t in range(warm):
        sh, pb, cd, _ = step_j(sh, pb, cd, comp, jnp.asarray(data[:, t]), t,
                               mode)
    state = jax.device_get((sh, pb, cd))
    before = _flat(state[0])
    sh_t, pb_t, cd_t = convert.from_jax_state(*state, device="cpu")
    back = _flat(dict(zip("spc", convert.to_numpy(sh_t, pb_t, cd_t))))
    ref0 = _flat(dict(zip("spc", state)))
    assert set(back) == set(ref0)
    for k in ref0:
        assert np.array_equal(back[k].reshape(ref0[k].shape), ref0[k]), k

    sh, pb, cd, ys = step_j(sh, pb, cd, comp, jnp.asarray(data[:, warm]),
                            warm, mode)
    step_t = E.make_byte_step(cfg, g, cpu)
    with torch.no_grad():
        sh_t, pb_t, cd_t, e32, c32 = step_t(
            sh_t, pb_t, cd_t, torch.zeros((b, cfg.comp_size),
                                          dtype=torch.uint8),
            torch.as_tensor(data[:, warm].copy()), torch.tensor(warm),
            torch.zeros(b, dtype=torch.int64))
    e32_j = np.stack([np.asarray(y) for y in ys[:8]], axis=1)
    assert np.array_equal(e32.numpy(), e32_j.astype(np.int64))
    assert np.array_equal(c32.numpy(), np.asarray(ys[8]).astype(np.int64))
    ref = _flat(dict(zip("spc", jax.device_get((sh, pb, cd)))))
    got = _flat(dict(zip("spc", convert.to_numpy(sh_t, pb_t, cd_t))))
    assert set(got) == set(ref)
    for k, r in ref.items():
        x = got[k].reshape(r.shape)
        if g.port:
            assert np.array_equal(x, r), k
        elif r.dtype.kind == "f":
            tol = 0.05 if k.endswith("qcum") else 2e-5
            np.testing.assert_allclose(x, r, atol=tol, rtol=0, err_msg=k)
        else:
            _fields_close(k, x, r)
    if states:
        return g, before, _flat(jax.device_get(sh))
    return g


# ---- the runner: archives of the two packages side by side

RUNNER_KW = dict(block_size=64, seg_size=64, tbits=12, mbits=12, ibits=10,
                 pbits=12, lstm_hidden=32, dmc_nodes=4096, lstm_horizon=4)
# archive size: the port against the JAX package at equal config; the f32
# sums run in another order, so predictions may drift apart after some
# hundred bytes -- the coded size must stay within 1%
SIZE_TOL = 0.01


def check_runner_against_jax(case, env, horizon=4):
    """compress 5 text blocks with the port at exec batch 3 (the second
    group padded with a dummy lane), RUNNER_KW's widths at LSTM horizon
    ``horizon``, against the JAX package's archive (golden ``case``) -> the
    same header, gate record and length-table flags, coded size within
    SIZE_TOL; the port's archive decodes exactly.  Returns the relative
    size gap."""
    from cmix_tpu_torch import engine as te
    from cmix_tpu_torch import runner as tr
    kw = dict(RUNNER_KW, lstm_horizon=horizon)
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[1000:1320]
    aj = jax_golden(case, data, config=kw, gates=env, max_batch=3)
    at = tr.compress(data, te.EngineConfig(**kw), max_batch=3, gates=env,
                     device="cpu")
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


# ---- the JAX package's runner under a gate set


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


# ---- the routed fixture: x86 code, a 24-bit BMP, a WAV and a baseline JPEG


def _bmp24(w, h, rng):
    """A 24-bit BMP (as tests/test_media.py makes one)."""
    rowbytes = (w * 3 + 3) & ~3
    hdr = b"BM" + struct.pack("<IHHI", 54 + rowbytes * h, 0, 0, 54)
    hdr += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                       rowbytes * h, 2835, 2835, 0, 0)
    y, x = np.mgrid[0:h, 0:w]
    base = ((x * 3 + y * 2) % 250).astype(np.uint8)
    px = np.zeros((h, rowbytes), dtype=np.uint8)
    for c in range(3):
        px[:, c:w * 3:3] = base + c + rng.integers(0, 3, (h, w),
                                                   dtype=np.uint8)
    return hdr + px.tobytes()


def _wav(nframes):
    """A 16-bit mono WAV (as tests/test_media.py makes one)."""
    t = np.arange(nframes)
    data = (3000 * np.sin(t / 9.0)).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16)
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<I", 16) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)


def transform_parity(data, blocks=(256, 4096, 65536)):
    """Both packages' ``transform`` of ``data`` in the present environment:
    the same payload and segment table, an exact ``untransform``, and the
    same ``block_strides``, ``block_kinds`` and ``block_jpeg_coords`` at
    each of ``blocks`` -> the port's segment table."""
    from cmix_tpu.preprocess import wrt as jwrt
    from cmix_tpu_torch.preprocess import wrt
    payload, meta = wrt.transform(data)
    ref_payload, ref_meta = jwrt.transform(data, None)
    assert payload == ref_payload
    assert meta == [tuple(e) for e in ref_meta]
    assert wrt.untransform(payload, meta) == data
    for block in blocks:
        nb = max(1, -(-len(payload) // block))
        for port_fn, jax_fn in ((wrt.block_strides, jwrt.block_strides),
                                (wrt.block_kinds, jwrt.block_kinds)):
            got, want = port_fn(meta, nb, block), jax_fn(ref_meta, nb, block)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        got = wrt.block_jpeg_coords(meta, nb, block)
        want = jwrt.block_jpeg_coords(ref_meta, nb, block)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    return meta


def make_jpeg(w=64, h=48, mode="RGB", seed=0, **save_kw):
    """A small baseline JPEG made by PIL (as tests/test_jpeg.py makes
    one); skips the calling test without PIL."""
    import io
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(seed)
    base = np.add.outer(np.arange(h) * 2, np.arange(w) * 3) % 256
    if mode == "L":
        arr = base.astype(np.uint8)
    else:
        arr = np.stack([base, np.roll(base, 5, 1), 255 - base],
                       axis=-1).astype(np.uint8)
    arr = np.clip(arr.astype(np.int32) + rng.integers(-8, 8, arr.shape), 0,
                  255).astype(np.uint8)
    buf = io.BytesIO()
    image.fromarray(arr, mode).save(buf, "JPEG", **save_kw)
    return buf.getvalue()


def make_routed_input():
    """The routed fixture's bytes, each part near the least the detector
    takes (the CPU codes it at ~15 ms per byte): 768 B of exe100k.raw that
    it calls x86 code, a 16x8 24-bit BMP, a WAV of 512 frames and a 32x16
    baseline JPEG of three components (PIL at writing time, hence a
    committed file)."""
    with open("testdata/exe100k.raw", "rb") as f:
        exe = f.read()[36864:36864 + 768]
    return b"".join([exe, _bmp24(16, 8, np.random.default_rng(4)), _wav(512),
                     make_jpeg(32, 16, quality=100)])


def make_gated_input():
    """The gated fixture's bytes: the routed fixture (x86 code, a BMP, a WAV
    and a JPEG, whose coefficient planes JVAL models) and ~1 KiB of text
    with table rows (the lines above that VMATCH votes from)."""
    with open("testdata/routed.raw", "rb") as f:
        routed = f.read()
    names = (b"alpha", b"beta", b"gamma", b"delta", b"omega", b"sigma")
    rows = b"".join(b"| %-5s | %4d | %-4s |\n" % (names[i % 6], i * 37 % 1000,
                                                  b"ok" if i % 3 else b"late")
                    for i in range(36))
    return (routed + b"\nThe table below lists each batch and its count.\n"
            + rows + b"Rows marked late were counted twice.\n")


# ---- the bench (cmix_tpu_torch/bench.py against bench.py's drive)

# RUNNER_KW's widths in 128-byte blocks of two 64-step segments, so that
# the transcoder's pipeline runs more than one segment a group
BENCH_KW = dict(RUNNER_KW, block_size=128, seg_size=64)


def bench_blocks():
    """4 blocks of bench4m.raw: the first 128 B of its 16 KiB blocks 0, 64,
    128 and 192 (text, word lists, ELF and source fragments)."""
    from cmix_tpu_torch import bench
    raw = np.frombuffer(bench.corpus(), np.uint8).reshape(256, -1)
    return raw[::64, :BENCH_KW["block_size"]].tobytes()


def jax_bench_encode(data, env, config):
    """(out, out_len) of ``cmix_tpu``'s transcoder on ``data`` at ``config``
    with ``env``'s gates, driven as bench.py drives it (``get_transcoder``,
    ``_group_state``, ``_split_blocks``; one coding group)."""
    from cmix_tpu import engine as je
    with jax_runner_gates(env) as jr:
        cfg = je.EngineConfig(**config)
        blocks = jr._split_blocks(data, cfg.block_size)
        b = blocks.shape[0]
        sh, pb = jr._group_state(cfg, b)
        _, out, out_len = jr.get_transcoder(cfg)(
            sh, pb, jnp.asarray(blocks),
            jnp.zeros((b, cfg.comp_size), dtype=jnp.uint8),
            jnp.int32(je.MODE_ENCODE))
        return np.asarray(out), np.asarray(out_len)


# ---- the JAX package's archives as committed goldens
#
# ``cmix_tpu`` is frozen, so its archive of fixed bytes under a fixed call
# is a constant.  testdata/jax_goldens.json holds one entry per case: the
# input (slices of committed files), the call (``compress`` at a config
# with its gates, environment, ``max_batch`` and dictionary; the bench's
# ``transcoder``; the ``cli`` in a subprocess), and the archive's sha256,
# length and committed file.  Tests take the archive from ``jax_golden``;
# tests/test_torch_goldens.py pins the frozen sources and package versions
# and, under RUN_SLOW=1, re-derives every golden with the JAX package.  The
# pin does not see the derivation's own code here (``derive_golden``,
# ``jax_bench_encode``, ``jax_runner_gates``, ``cli_env``, ``run_cli``) or
# the environment (``XLA_FLAGS``): after a change to either, run
# ``--write-goldens`` and then the RUN_SLOW test.  A new case: add its entry
# without the derived fields, then ``JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/torch_parity.py --write-goldens CASE``.

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "testdata", "jax_goldens.json")
# the JAX package's sources: its tree and the native library it builds
FROZEN = ("cmix_tpu", os.path.join("native", "preproc.cpp"))
# the installed packages the goldens were written under (numpy: the JAX
# package's host JPEG recode and WRT run on it)
FROZEN_VERSIONS = ("jax", "jaxlib", "numpy")
# an entry's call fields, as a test states them (the rest take these)
CALL = dict(call="compress", config=None, args=None, gates={}, env={},
            max_batch=None, dictionary=None)


def sha256(data):
    return hashlib.sha256(data).hexdigest()


def goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def read_parts(parts):
    """The bytes of an entry's input: its [path, start, stop] slices of
    committed files (``stop`` null: to the end), joined."""
    out = []
    for path, start, stop in parts:
        with open(os.path.join(ROOT, path), "rb") as f:
            out.append(f.read()[start:stop])
    return b"".join(out)


def freeze_digest():
    """(sha256 over the frozen sources in sorted path order: each path and
    the sha256 of its bytes; the number of files).  Build outputs and
    bytecode are not sources."""
    paths = []
    for top in FROZEN:
        if os.path.isfile(os.path.join(ROOT, top)):
            paths.append(top)
        for d, dirs, files in os.walk(os.path.join(ROOT, top)):
            dirs[:] = [x for x in dirs if x != "__pycache__"]
            paths += [os.path.relpath(os.path.join(d, x), ROOT) for x in files
                      if not x.endswith((".pyc", ".so"))]
    h = hashlib.sha256()
    for rel in sorted(paths):
        with open(os.path.join(ROOT, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + hashlib.sha256(f.read()).digest())
    return h.hexdigest(), len(paths)


def jax_golden(case, data, **call):
    """The JAX package's committed archive for golden ``case``, after
    asserting that ``data`` and the test's ``call`` (the fields of CALL it
    sets; ``dictionary`` a path) are the entry's and that the file has the
    entry's sha256 and length.  RUN_SLOW=1 pytest
    tests/test_torch_goldens.py re-derives it with the JAX package."""
    e = goldens()["cases"][case]
    assert sha256(data) == e["input_sha256"], case
    want = json.loads(json.dumps(dict(CALL, **call)))
    dic = want.pop("dictionary")
    assert {k: e[k] for k in want} == want, case
    if dic is None:
        assert e["dictionary"] is None, case
    else:
        with open(dic, "rb") as f:
            assert f.read() == read_parts(e["dictionary"]), case
    with open(os.path.join(ROOT, e["file"]), "rb") as f:
        arc = f.read()
    assert (sha256(arc), len(arc)) == (e["sha256"], e["length"]), case
    return arc


def jax_golden_streams(case, data, **call):
    """(out, out_len) of a ``transcoder`` golden: its file holds the streams
    cut to their lengths, then the lengths as little-endian int64."""
    blob = jax_golden(case, data, call="transcoder", **call)
    b = len(data) // call["config"]["block_size"]
    out_len = np.frombuffer(blob[-8 * b:], "<i8")
    return np.frombuffer(blob[:-8 * b], np.uint8).reshape(b, -1), out_len


def cli_env(**env):
    """A subprocess environment for either package's CLI: no gate or route
    switch of the caller's, the CPU, one thread, ``env`` on top."""
    from cmix_tpu_torch import engine as E
    out = {k: v for k, v in os.environ.items() if k not in E.GATE_NAMES
           and k not in ("JVAL_ROUTE", "WRTW_ROUTE", "CMIX_JPEGC")}
    out.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out.update(env)
    return out


def run_cli(package, args, env):
    """``python -m <package>.runner <args>`` in ``env``; it must exit 0."""
    p = subprocess.run([sys.executable, "-m", f"{package}.runner"] + args,
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]


def derive_golden(e, tmp):
    """The JAX package's archive for entry ``e``, computed now (files and
    pretraining caches under the directory ``tmp``), and its decode of that
    archive where the entry asks for one (``decode``: the decode's keyword
    arguments; the ``cli`` decodes in an environment without the gates),
    else None."""
    from cmix_tpu import engine as je
    from cmix_tpu.utils import checkpoint as jck
    data = read_parts(e["input"])
    dec = e["decode"]
    if e["call"] == "cli":
        src, arc, back = (os.path.join(tmp, n)
                          for n in ("in.txt", "j.tcmx", "j.out"))
        with open(src, "wb") as f:
            f.write(data)
        run_cli("cmix_tpu", ["c", src, arc] + e["args"], cli_env(**e["env"]))
        if dec is not None:
            run_cli("cmix_tpu", ["d", arc, back], cli_env())
            with open(back, "rb") as f:
                dec = f.read()
        with open(arc, "rb") as f:
            return f.read(), dec
    if e["call"] == "transcoder":
        out, out_len = jax_bench_encode(data, e["gates"], e["config"])
        keep = np.arange(out.shape[1])[None, :] < out_len[:, None]
        return (np.where(keep, out, 0).astype(np.uint8).tobytes()
                + out_len.astype("<i8").tobytes()), None
    kw = {} if e["max_batch"] is None else {"max_batch": e["max_batch"]}
    dkw = {}
    if e["dictionary"] is not None:
        dkw["dictionary"] = os.path.join(tmp, "golden.dic")
        with open(dkw["dictionary"], "wb") as f:
            f.write(read_parts(e["dictionary"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jck, "CACHE_DIR", os.path.join(tmp, "cache"))
        for k, v in e["env"].items():
            mp.setenv(k, v)
        with jax_runner_gates(e["gates"]) as jr:
            arc = jr.compress(data, je.EngineConfig(**e["config"]), **kw,
                              **dkw)
            if dec is not None:
                dec = jr.decompress(arc, **dec, **dkw)
    return arc, dec


def write_goldens(cases=()):
    """Derive ``cases`` (all by default) with the JAX package and write their
    files and derived fields; the freeze digest is recorded only when every
    case is written, and a subset is written only under the recorded one."""
    import importlib.metadata
    import tempfile
    table = goldens()
    digest, nfiles = freeze_digest()
    if cases:
        assert table["freeze"]["sha256"] == digest, (
            "the JAX package changed: write every case")
    else:
        cases = list(table["cases"])
        table["freeze"] = dict(
            sha256=digest, files=nfiles,
            **{m: importlib.metadata.version(m) for m in FROZEN_VERSIONS})
    for case in cases:
        e = table["cases"][case]
        data = read_parts(e["input"])
        with tempfile.TemporaryDirectory() as tmp:
            arc, back = derive_golden(e, tmp)
        assert back in (None, data), f"{case}: the JAX package's decode"
        e.update(input_sha256=sha256(data), sha256=sha256(arc),
                 length=len(arc))
        os.makedirs(os.path.dirname(os.path.join(ROOT, e["file"])),
                    exist_ok=True)
        with open(os.path.join(ROOT, e["file"]), "wb") as f:
            f.write(arc)
        print(f"{case}: {e['file']}, {len(arc)} bytes")
    with open(GOLDENS, "w") as f:
        f.write(json.dumps(table, indent=1) + "\n")


if __name__ == "__main__" and sys.argv[1:2] == ["--write-goldens"]:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
    # --write-goldens [CASE ...]: (re)write the JAX package's goldens
    write_goldens(sys.argv[2:])
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
