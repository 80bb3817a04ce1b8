"""Dynamic Markov Coding model, batched over blocks.

Port of cmix_tpu/models/dmc.py: the same packed layout, deferred-update
design and format-defining clone rules.

* ``dmc_nxt (B, N) int32``: u32 bits, lo16 = successor on bit 0,
  hi16 = successor on bit 1.
* ``dmc_cnt (B, N) int32``: lo16/hi16 = the state's two edge counts in
  fixed-point 1/8 units.

The flat (B, N) layout is kept: the JAX package's (N/1024, 8, 128) tile
layout existed only for TPU VMEM.  ``plan_step`` turns a coded byte into
<= 40 pending edge-update descriptors; the next byte's ``predict_step``
applies them and walks the byte tree.  On a CUDA tensor that is one launch
of the hand-written kernel ``csrc/dmc_fused.cu``; on a CPU tensor it is the
plain PyTorch version (``_apply_plain`` + ``_walk_plain``) beside it.

``counts_walk`` is the JAX package's second DMC kernel, the prediction-only
walk (``csrc/dmc_counts.cu``, plain version ``_counts_plain``); like its
TPU original it is reached from no entry point of the system.
"""

import ctypes

import numpy as np
import torch

from cmix_tpu_torch import build
from cmix_tpu_torch.mixer.ilstm import ilstm_shared_byte_update
from cmix_tpu_torch.u32 import to_bits

UNIT = 8
INIT_U = 2
CLONE_TH1_U = 16
CLONE_TH2_U = 16
LIMIT_U = 255 * UNIT
N_COPIES = 16
N_BASE = N_COPIES * 255
N_UX, N_UP = 24, 8            # count / pointer descriptors per block

DMC_KEYS = ("dmc_nxt", "dmc_cnt", "dmc_cur", "dmc_top")
DMC_UPD_KEYS = ("dmc_uX", "dmc_uXC", "dmc_uS", "dmc_uSW",
                "dmc_uU", "dmc_uUW")
DMC_STATE_KEYS = DMC_KEYS + DMC_UPD_KEYS


def init_machine(n_nodes: int):
    """(nxt (N,) int32 packed bits, cnt (N,) int32 packed) as numpy."""
    if not N_BASE + 2 <= n_nodes <= 65536:
        raise ValueError(f"dmc pool {n_nodes} outside [{N_BASE + 2}, 65536]")
    nxt = np.zeros((n_nodes, 2), dtype=np.int64)
    for c in range(N_COPIES):
        base = c * 255
        for n in range(1, 256):
            for b in (0, 1):
                if n < 128:
                    nxt[base + n - 1, b] = base + (2 * n + b) - 1
                else:
                    v = ((n << 1) | b) & 0xFF
                    nxt[base + n - 1, b] = (v >> 4) * 255
    packed = (nxt[:, 0] | (nxt[:, 1] << 16)).astype(np.uint32)
    cnt = np.full(n_nodes, INIT_U | (INIT_U << 16), dtype=np.uint32)
    return packed.view(np.int32), cnt.view(np.int32)


def init_dmc_perblock(n_nodes: int, B: int, device):
    nxt, cnt = init_machine(n_nodes)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "dmc_nxt": torch.as_tensor(nxt, device=device).repeat(B, 1),
        "dmc_cnt": torch.as_tensor(cnt, device=device).repeat(B, 1),
        "dmc_cur": torch.zeros(B, **i32),
        "dmc_top": torch.full((B,), N_BASE, **i32),
        "dmc_uX": torch.full((B, N_UX), -1, **i32),
        "dmc_uXC": torch.zeros((B, N_UX), **i32),
        "dmc_uS": torch.full((B, N_UP), -1, **i32),
        "dmc_uSW": torch.zeros((B, N_UP), **i32),
        "dmc_uU": torch.full((B, N_UP), -1, **i32),
        "dmc_uUW": torch.zeros((B, N_UP), **i32),
    }


def _unpack(w):
    return w & 0xFFFF, (w >> 16) & 0xFFFF


# ------------------------------------------------ plain version (CPU path)


def _apply_plain(nxt, cnt, uX, uXC, uS, uSW, uU, uUW):
    """Apply the pending descriptors in place, in kernel order: counts,
    then clone pointers, then path pointers.  Duplicate indices inside a
    group carry identical words, so the write order within one is free."""
    for tbl, idx, val in ((cnt, uX, uXC), (nxt, uU, uUW), (nxt, uS, uSW)):
        ok = idx >= 0
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        tbl[rows.expand_as(idx)[ok], idx[ok].long()] = val[ok]


def _walk_plain(nxt, cnt, cur, levels):
    """-> (cw (B, 2^L) int32, vis (B, 2^L) int32, wn (B, 2^(L-1)) int32)."""
    B = nxt.shape[0]
    frontier = cur.long()[:, None]
    visited = [torch.zeros_like(frontier), frontier]
    words = [torch.zeros((B, 1), dtype=torch.int32, device=nxt.device)]
    for _ in range(1, levels):
        word = torch.gather(nxt, 1, frontier)
        words.append(word)
        c0, c1 = _unpack(word.long())
        frontier = torch.stack([c0, c1], dim=2).reshape(B, -1)
        visited.append(frontier)
    vis = torch.cat(visited, dim=1)
    return (torch.gather(cnt, 1, vis), vis.to(torch.int32),
            torch.cat(words, dim=1))


# ---------------------------------------------------------- CUDA kernel


def _kernel_lib(name, n_ptr):
    """The built ``csrc/<name>.cu``: n_ptr pointers, then (batch, n_nodes,
    levels) ints and the stream."""
    lib = build.load(name)
    fn = getattr(lib, name)
    if not getattr(lib, "_argtypes_set", False):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib._argtypes_set = True
    return fn


def fused_apply_walk(nxt, cnt, cur, uX, uXC, uS, uSW, uU, uUW, levels):
    """Apply pending descriptors to (nxt, cnt) IN PLACE, then walk.

    -> (cw, vis, wn).  CUDA tensors launch ``csrc/dmc_fused.cu`` (and count
    the launch in ``fused_apply_walk.launches``); CPU tensors take the
    plain version.  Anything else raises."""
    if not 1 <= levels <= 8:
        raise ValueError(f"levels={levels} outside 1..8")
    if not nxt.is_cuda:
        _apply_plain(nxt, cnt, uX, uXC, uS, uSW, uU, uUW)
        return _walk_plain(nxt, cnt, cur, levels)
    B, N = nxt.shape
    args = (nxt, cnt, cur, uX, uXC, uS, uSW, uU, uUW)
    build.check_operands("dmc_fused", args, (
        (B, N), (B, N), (B,), (B, N_UX), (B, N_UX), (B, N_UP), (B, N_UP),
        (B, N_UP), (B, N_UP)), nxt.device)
    cw = torch.empty((B, 1 << levels), dtype=torch.int32, device=nxt.device)
    vis = torch.empty_like(cw)
    wn = torch.empty((B, 1 << (levels - 1)), dtype=torch.int32,
                     device=nxt.device)
    stream = torch.cuda.current_stream(nxt.device).cuda_stream
    rc = _kernel_lib("dmc_fused", 12)(
        *(a.data_ptr() for a in args), cw.data_ptr(), vis.data_ptr(),
        wn.data_ptr(), B, N, levels, stream)
    if rc != 0:
        raise RuntimeError(f"dmc_fused launch failed: CUDA error {rc}")
    fused_apply_walk.launches += 1
    return cw, vis, wn


fused_apply_walk.launches = 0


def _counts_plain(nxt, cnt, cur, levels):
    """Count words of the 2^L walked states, zero-padded: (B, 256) int32."""
    cw = _walk_plain(nxt, cnt, cur, levels)[0]
    return torch.cat([cw, torch.zeros((cw.shape[0], 256 - cw.shape[1]),
                                      dtype=cw.dtype, device=cw.device)],
                     dim=1)


def counts_walk(nxt, cnt, cur, levels):
    """Prediction-only walk (no pending updates; the tables are only
    read) -> (B, 256) int32 count words, zero past 2^levels.

    CUDA tensors launch ``csrc/dmc_counts.cu`` (counted in
    ``counts_walk.launches``); CPU tensors take ``_counts_plain``."""
    if not 1 <= levels <= 8:
        raise ValueError(f"levels={levels} outside 1..8")
    if not nxt.is_cuda:
        return _counts_plain(nxt, cnt, cur, levels)
    B, N = nxt.shape
    build.check_operands("dmc_counts", (nxt, cnt, cur),
                         ((B, N), (B, N), (B,)), nxt.device)
    out = torch.empty((B, 256), dtype=torch.int32, device=nxt.device)
    stream = torch.cuda.current_stream(nxt.device).cuda_stream
    rc = _kernel_lib("dmc_counts", 4)(
        nxt.data_ptr(), cnt.data_ptr(), cur.data_ptr(), out.data_ptr(), B, N,
        levels, stream)
    if rc != 0:
        raise RuntimeError(f"dmc_counts launch failed: CUDA error {rc}")
    counts_walk.launches += 1
    return out


counts_walk.launches = 0


# the kernel wrappers, each counting its launches in ``.launches``: both
# DMC kernels and the portable LSTM's update chain (``mixer/ilstm.py``)
WRAPPERS = (fused_apply_walk, counts_walk, ilstm_shared_byte_update)


def launch_counts():
    """[launches] of each wrapper of ``WRAPPERS``."""
    return [w.launches for w in WRAPPERS]


def add_launches(counts, times=1):
    """Add ``times`` x ``counts`` (one entry per wrapper) to the launch
    counts.  A CUDA graph's replay launches what its capture recorded
    without calling a wrapper: the graph adds the launches its capture
    counted once per replay (``engine.make_segment_fn``)."""
    for w, n in zip(WRAPPERS, counts):
        w.launches += n * times


# ------------------------------------------------------------ model API


def predict_step(pb, levels):
    """Apply pending updates, then walk -> (state updates, walk outputs).

    The tables are updated in place (the returned dict holds the same
    tensors); walk = {cw, vis, wn} feeds prediction and ``plan_step``."""
    cw, vis, wn = fused_apply_walk(
        pb["dmc_nxt"], pb["dmc_cnt"], pb["dmc_cur"], pb["dmc_uX"],
        pb["dmc_uXC"], pb["dmc_uS"], pb["dmc_uSW"], pb["dmc_uU"],
        pb["dmc_uUW"], levels)
    return ({"dmc_nxt": pb["dmc_nxt"], "dmc_cnt": pb["dmc_cnt"]},
            {"cw": cw, "vis": vis, "wn": wn})


def probs_from_counts(cw):
    """p(bit=1) per tree node from gathered count words: f32 (B, 256)."""
    c0u, c1u = _unpack(cw)
    c0 = c0u.float() * (1.0 / UNIT)
    c1 = c1u.float() * (1.0 / UNIT)
    probs = (c1 + 0.3) / (c0 + c1 + 0.6)
    if probs.shape[1] < 256:
        probs = torch.cat([probs, torch.full(
            (probs.shape[0], 256 - probs.shape[1]), 0.5,
            dtype=probs.dtype, device=probs.device)], dim=1)
    return probs


def p12_from_counts(cw):
    """Integer twin (portable profile): p12 int32 (B, 256), the same
    (c1+0.3)/(c0+c1+0.6) as an exact floor division, 2048 past the walk."""
    c0u, c1u = _unpack(cw)
    num = 10 * c1u + 3 * UNIT
    den = 10 * (c0u + c1u) + 6 * UNIT
    p12 = torch.clamp((num << 12) // den, 1, 4095)
    if p12.shape[1] < 256:
        p12 = torch.cat([p12, torch.full(
            (p12.shape[0], 256 - p12.shape[1]), 2048, dtype=p12.dtype,
            device=p12.device)], dim=1)
    return p12


def _g1(tbl, i):
    return torch.gather(tbl, 1, i[:, None])[:, 0].long()


def plan_step(pb, walk, byte, levels):
    """Plan every block's 8-edge advance (byte: (B,) int64) into pending
    descriptors; see cmix_tpu/models/dmc.py plan_step for the rules."""
    nxt, cnt = pb["dmc_nxt"], pb["dmc_cnt"]
    dev = nxt.device
    N = nxt.shape[1]
    top = pb["dmc_top"].long()
    L = levels
    k8 = torch.arange(8, device=dev)
    n8 = (1 << k8)[None, :] + (byte[:, None] >> (8 - k8)[None, :])
    Bv = (byte[:, None] >> (7 - k8)[None, :]) & 1
    S_pre = torch.gather(walk["vis"], 1, n8[:, :L]).long()
    CS_pre = torch.gather(walk["cw"], 1, n8[:, :L]).long()
    WS_pre = torch.gather(walk["wn"], 1, n8[:, :L - 1]).long() & 0xFFFFFFFF
    s_list = [S_pre[:, k] for k in range(L)]
    cs_list = [CS_pre[:, k] for k in range(L)]
    ws_list = [WS_pre[:, k] for k in range(L - 1)]
    t_list = []
    for k in range(8):
        if k >= L:
            s_list.append(t_list[k - 1])
            cs_list.append(_g1(cnt, t_list[k - 1]))
        if k >= L - 1:
            ws_list.append(_g1(nxt, s_list[k]) & 0xFFFFFFFF)
        n0, n1 = _unpack(ws_list[k])
        t_list.append(torch.where(Bv[:, k] == 1, n1, n0))
    S = torch.stack(s_list, dim=1)
    T = torch.stack(t_list, dim=1)
    WS = torch.stack(ws_list, dim=1)
    CS = torch.stack(cs_list, dim=1)
    cs0, cs1 = _unpack(CS)
    c_sb = torch.where(Bv == 1, cs1, cs0)

    cT7 = _g1(cnt, T[:, 7])[:, None]
    cT = torch.cat([CS[:, 1:], cT7], dim=1)
    cT0, cT1 = _unpack(cT)
    tot_t = cT0 + cT1
    want = (c_sb >= CLONE_TH1_U) & (tot_t - c_sb >= CLONE_TH2_U) & (T != S)
    slot = top[:, None] + torch.cumsum(want.long(), dim=1) - 1
    do_clone = want & (slot < N)
    U = torch.where(do_clone, slot, T)
    den = torch.clamp(tot_t, min=1)
    moved0 = torch.where(do_clone, cT0 * c_sb // den, 0)
    moved1 = torch.where(do_clone, cT1 * c_sb // den, 0)

    X = torch.cat([S, T, U], dim=1)                           # (B, 24)
    D0 = torch.cat([torch.where(Bv == 0, UNIT, 0), -moved0,
                    torch.where(do_clone, moved0 - INIT_U, 0)], dim=1)
    D1 = torch.cat([torch.where(Bv == 1, UNIT, 0), -moved1,
                    torch.where(do_clone, moved1 - INIT_U, 0)], dim=1)
    E = X[:, :, None] == X[:, None, :]
    agg0 = torch.where(E, D0[:, None, :], 0).sum(dim=2)
    agg1 = torch.where(E, D1[:, None, :], 0).sum(dim=2)
    init_w = INIT_U | (INIT_U << 16)
    cU = torch.where(do_clone, init_w, cT)
    x0, x1 = _unpack(torch.cat([CS, cT, cU], dim=1))
    n0 = torch.clamp(x0 + agg0, min=0)
    n1 = torch.clamp(x1 + agg1, min=0)
    halve = torch.maximum(n0, n1) > LIMIT_U
    n0 = torch.where(halve, n0 >> 1, n0)
    n1 = torch.where(halve, n1 >> 1, n1)
    new_cw = n0 | (n1 << 16)

    wT7 = _g1(nxt, T[:, 7])[:, None] & 0xFFFFFFFF
    wT = torch.cat([WS[:, 1:], wT7], dim=1)
    ucl = torch.where(do_clone, U, -1)
    ordk = k8[None, None, :]
    sameS = S[:, :, None] == S[:, None, :]

    def _field(fbit, orig):
        # for entry i: the U of the LAST entry j with S_j == S_i, b_j == f
        valid = sameS & (Bv[:, None, :] == fbit)
        rank = torch.where(valid, ordk, -1)
        jbest = torch.argmax(rank, dim=2)
        hasf = rank.max(dim=2).values >= 0
        return torch.where(hasf, torch.gather(U, 1, jbest), orig)

    ws0, ws1 = _unpack(WS)
    new_ws = _field(0, ws0) | (_field(1, ws1) << 16)
    i32 = torch.int32
    return {"dmc_cur": U[:, 7].to(i32),
            "dmc_top": (top + do_clone.sum(dim=1)).to(i32),
            "dmc_uX": X.to(i32), "dmc_uXC": to_bits(new_cw),
            "dmc_uS": S.to(i32), "dmc_uSW": to_bits(new_ws),
            "dmc_uU": ucl.to(i32), "dmc_uUW": to_bits(wT)}


def byte_update(pb, byte, levels):
    """Immediate form (tests): walk, plan and apply in one call."""
    cw, vis, wn = _walk_plain(pb["dmc_nxt"], pb["dmc_cnt"], pb["dmc_cur"],
                              levels)
    upd = plan_step(pb, {"cw": cw, "vis": vis, "wn": wn}, byte, levels)
    nxt, cnt = pb["dmc_nxt"].clone(), pb["dmc_cnt"].clone()
    _apply_plain(nxt, cnt, upd["dmc_uX"], upd["dmc_uXC"], upd["dmc_uS"],
                 upd["dmc_uSW"], upd["dmc_uU"], upd["dmc_uUW"])
    return {"dmc_nxt": nxt, "dmc_cnt": cnt,
            "dmc_cur": upd["dmc_cur"], "dmc_top": upd["dmc_top"]}
