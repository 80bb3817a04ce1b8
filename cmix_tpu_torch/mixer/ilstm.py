"""Portable integer LSTM byte mixer (the PORT-profile twin of lstm.py).

Port of cmix_tpu/mixer/ilstm.py: the same format-defining integer
re-spec, operation for operation, on int32 tensors.

* one layer, fused gates, input gate = 1 - forget (the coupling bounds the
  cell state to +-1.0 and replaces layer norm);
* truncated BPTT over the engine's horizon window with the loss injected
  at every position, the backward pass derived by hand in fixed point (no
  autograd: the integer ops have no gradient, and a float backward would
  break portability);
* mean-over-batch SGD with gradient clipping, or the integer Adam with a
  power-of-two denominator under ILSTM_ADAM.

Every contraction is an int32 einsum in the JAX package; here it is
``intmath.ieinsum`` (exact sum wrapped to int32), so the result is the
same on the CPU and the card.

``ilstm_shared_byte_update`` is the wrapper of the update: CUDA tensors
launch the hand-written kernel chain ``csrc/ilstm_update.cu`` (three
launches, counted in its ``.launches``); CPU tensors take the plain
version ``_update_plain``, which the tests hold against the JAX package.

Fixed-point domains:
  activations h, c, gate outputs: Q12 (4096 = 1.0), |.| <= 4096
  pre-activations, gradients:     Q12, clipped
  weights Wh/Wo:                  Q16, |.| <= 4*65536
  weights Wx/b/bo:                Q12 pre-activation contributions
  qcum:                           int32 cumulative, ~2^16 total
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from cmix_tpu_torch import build
from cmix_tpu_torch.utils.intmath import (
    ST13_MAX, ST13_MIN, _exp2_parts, _lut, ieinsum, squash12, squash12_lut)

W_CLIP = 4 * 65536          # Q16 weight bound (exactness of _dot16)
PRE_CLIP = 32760            # Q12 pre-activation bound (+-8 real)
G_CLIP = 1 << 14            # per-step gradient bound (+-4 in Q12)
I32 = torch.int32


@dataclass(frozen=True)
class ILstmConfig:
    hidden: int = 256
    horizon: int = 8

    def __post_init__(self):
        # the JAX package's _dot16 bound: |a| <= 4096 times |w_hi| <= 1024
        # times H must stay below 2^31 in its int32 sums
        if self.hidden > 256:
            raise ValueError(
                f"ILstm hidden={self.hidden} > 256 breaks the _dot16 "
                "int32 exactness bound (PORT profile)")
    lr_wx: int = 192         # Q16 learning rates (lr/65536 per unit grad)
    lr_wh: int = 96
    lr_wo: int = 96
    lr_b: int = 48
    adam: bool = False       # integer Adam-class optimizer (ILSTM_ADAM)
    alr_wx: int = 40         # Q12 Adam step sizes
    alr_wh: int = 20
    alr_wo: int = 20
    alr_b: int = 10


def _splitmix_stream(seed):
    """The JAX package's counter-based splitmix32 weight stream (numpy,
    copied as is): each value an integer hash of (seed, index)."""
    ctr = [0]

    def rnd(n, scale):
        i = np.arange(ctr[0], ctr[0] + n, dtype=np.uint64)
        ctr[0] += n
        z = (np.uint64(seed) + i * np.uint64(0x9E3779B97F4A7C15)) \
            & np.uint64(0xFFFFFFFFFFFFFFFF)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z &= np.uint64(0xFFFFFFFFFFFFFFFF)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z &= np.uint64(0xFFFFFFFFFFFFFFFF)
        z = (z ^ (z >> np.uint64(31))) & np.uint64(0xFFFFFFFF)
        return ((z % np.uint64(2 * scale + 1)).astype(np.int64)
                - scale).astype(np.int32)
    return rnd


def init_ilstm_shared(cfg: ILstmConfig, device, seed: int = 0x5A17):
    """Deterministic integer init (format constants)."""
    h = cfg.hidden
    rnd = _splitmix_stream(seed)
    t = lambda a: torch.as_tensor(a, device=device)          # noqa: E731
    sh = {
        "wx": t(rnd(256 * 3 * h, 256).reshape(256, 3 * h)),
        "wh": t(rnd(h * 3 * h, 2048).reshape(h, 3 * h)),
        "wo": t(rnd(h * 256, 2048).reshape(h, 256)),
        "b": torch.zeros(3 * h, dtype=I32, device=device),
        "bo": torch.zeros(256, dtype=I32, device=device),
    }
    if cfg.adam:
        for k in ("wx", "wh", "wo", "b", "bo"):
            sh["m_" + k] = torch.zeros_like(sh[k])
            sh["v_" + k] = torch.zeros_like(sh[k])
    return sh


def init_ilstm_perblock(cfg: ILstmConfig, B, device):
    z = lambda *s: torch.zeros((B,) + s, dtype=I32, device=device)  # noqa
    return {"h": z(cfg.hidden), "c": z(cfg.hidden), "h0": z(cfg.hidden),
            "c0": z(cfg.hidden), "ring": z(cfg.horizon),
            "qcum": (torch.arange(257, dtype=I32, device=device) * 256
                     ).repeat(B, 1)}


def _sum32(x, dim, keepdim=False):
    """int32 sum that wraps like XLA's (torch sums integers in int64)."""
    return x.sum(dim=dim, keepdim=keepdim).to(I32)


def _dot16(eq, a, w):
    """(sum a*w) >> 16 with Q16 weights split hi/lo, as the JAX package."""
    w_hi = w >> 8
    w_lo = w - (w_hi << 8)
    return (ieinsum(eq, a, w_hi) >> 8) + (ieinsum(eq, a, w_lo) >> 16)


def _sig12(pre):
    """sigmoid of a Q12 pre-activation -> Q12 in [1, 4095]."""
    return squash12_lut(4096 + (torch.clamp(pre, -PRE_CLIP, PRE_CLIP) >> 4))


def _tanh12(x):
    """tanh of a Q12 value -> Q12 in [-4094, 4094]."""
    return 2 * squash12_lut(
        4096 + (torch.clamp(x, -PRE_CLIP, PRE_CLIP) >> 3)) - 4096


def _cell(sh, h, c, byte):
    """One integer cell step.  h, c (B, H) Q12; byte (B,) integer.
    Returns (h2, c2, stash) with everything the backward pass needs."""
    H = h.shape[1]
    pre = (sh["wx"][byte.long()] + _dot16("bh,hk->bk", h, sh["wh"])
           + sh["b"][None])
    pre = torch.clamp(pre, -PRE_CLIP, PRE_CLIP)
    f = _sig12(pre[:, :H])
    g = _tanh12(pre[:, H:2 * H])
    o = _sig12(pre[:, 2 * H:])
    c2 = (f * c + (4096 - f) * g) >> 12          # |c2| <= 4096 (coupled)
    tc = _tanh12(c2)
    h2 = (o * tc) >> 12
    return h2, c2, (h, c, f, g, o, tc)


def _softmax_parts(sh, h):
    """Integer softmax pieces of the output head: (p15 (B, 256), vi,
    total)."""
    logits = torch.clamp(sh["bo"][None] + _dot16("bh,hk->bk", h, sh["wo"]),
                         -(3072 << 4), 3072 << 4)    # Q12, +-12 real
    logits = logits - logits.max(dim=1, keepdim=True).values
    st13x = torch.clamp(logits >> 4, min=-3072)      # 256*ln units, <= 0
    z, k = _exp2_parts(st13x)                        # val = z * 2^(k-15)
    s = torch.clamp(-k, 0, 31)
    vi = torch.clamp((z >> s) + 1, max=65535)        # [1, 2^16)
    total = _sum32(vi, 1, keepdim=True)              # < 2^25
    p15 = ((vi.long() << 15) // total.long()).to(I32)
    return p15, vi, total


def ilstm_shared_byte_update(cfg: ILstmConfig, sh, pb, bytes_b):
    """Replay the horizon window forward (stashing), run the integer
    backward, update the shared weights (mean-over-batch SGD or the
    integer Adam), slide the window, advance the running state and cache
    the next-byte integer distribution.  bytes_b: (B,) integer, bytes.

    -> (sh, pb), new tensors.  CUDA tensors launch ``csrc/ilstm_update.cu``
    (counted in ``ilstm_shared_byte_update.launches``, 3 an update); CPU
    tensors take the plain version, ``_update_plain``.  Operands the kernel
    does not take raise ValueError."""
    if not sh["wh"].is_cuda:
        return _update_plain(cfg, sh, pb, bytes_b)
    dev = sh["wh"].device
    out = _launch(_kernel_lib(), cfg, sh, pb, bytes_b,
                  torch.cuda.current_stream(dev).cuda_stream,
                  _lanes(bytes_b.shape[0], dev))
    ilstm_shared_byte_update.launches += LAUNCHES
    return out


ilstm_shared_byte_update.launches = 0


def _update_plain(cfg: ILstmConfig, sh, pb, bytes_b):
    """The update in plain PyTorch (the CPU path)."""
    B = bytes_b.shape[0]
    H, W = cfg.hidden, cfg.horizon
    dev = bytes_b.device
    bytes_b = bytes_b.to(I32)
    ring = pb["ring"]                                        # (B, W)
    targets = torch.cat([ring[:, 1:], bytes_b[:, None]], dim=1)

    # ---- forward replay, stashing per-step state
    h, c = pb["h0"], pb["c0"]
    stash = []
    for j in range(W):
        h, c, st = _cell(sh, h, c, ring[:, j])
        stash.append((ring[:, j], targets[:, j], st, h))

    # ---- backward through time (integer)
    z = lambda *s: torch.zeros(s, dtype=I32, device=dev)     # noqa: E731
    gwx, gwh, gwo = z(256, 3 * H), z(H, 3 * H), z(H, 256)
    gb, gbo = z(3 * H), z(256)
    dh, dc = z(B, H), z(B, H)
    ar256 = torch.arange(256, device=dev)
    for j in range(W - 1, -1, -1):
        byte_j, tgt_j, (h_prev, c_prev, f, g, o, tc), h_j = stash[j]
        p15, _, _ = _softmax_parts(sh, h_j)
        onehot = ar256[None, :] == tgt_j[:, None]
        dlog = (p15 - torch.where(onehot, 1 << 15, 0).to(I32)) >> 3
        gbo = gbo + _sum32(dlog, 0)
        gwo = gwo + ieinsum("bh,bk->hk", h_j >> 4, dlog >> 4)
        dh = torch.clamp(dh + _dot16("bk,hk->bh", dlog, sh["wo"]),
                         -(1 << 15), 1 << 15)
        # cell backward
        do = (dh * tc) >> 12
        dtc = (dh * o) >> 12
        dc = torch.clamp(
            dc + ((dtc * ((4096 * 4096 - tc * tc) >> 12)) >> 12),
            -(1 << 15), 1 << 15)
        df = (dc * (c_prev - g)) >> 12
        dg = (dc * (4096 - f)) >> 12
        dpre_f = (df * ((f * (4096 - f)) >> 12)) >> 12
        dpre_g = (dg * ((4096 * 4096 - g * g) >> 12)) >> 12
        dpre_o = (do * ((o * (4096 - o)) >> 12)) >> 12
        dpre = torch.clamp(torch.cat([dpre_f, dpre_g, dpre_o], dim=1),
                           -G_CLIP, G_CLIP)
        oh_b = (ar256[None, :] == byte_j[:, None]).to(I32)   # (B, 256)
        gwx = gwx + ieinsum("bv,bk->vk", oh_b, dpre)
        gwh = gwh + ieinsum("bh,bk->hk", h_prev >> 4, dpre >> 4)
        gb = gb + _sum32(dpre, 0)
        dh = _dot16("bk,hk->bh", torch.clamp(dpre, -2047, 2047), sh["wh"])
        dc = (dc * f) >> 12

    grads = (("wx", gwx, cfg.lr_wx, cfg.alr_wx, PRE_CLIP),
             ("wh", gwh, cfg.lr_wh, cfg.alr_wh, W_CLIP),
             ("wo", gwo, cfg.lr_wo, cfg.alr_wo, W_CLIP),
             ("b", gb, cfg.lr_b, cfg.alr_b, PRE_CLIP),
             ("bo", gbo, cfg.lr_b, cfg.alr_b, PRE_CLIP))
    new = {}
    if cfg.adam:
        # integer Adam, power-of-two denominator; the static pre-shift
        # keeps the raw B*W gradient sums inside +-2^15
        pre_sh = max(0, (B * W).bit_length() - 5)
        for wkey, grad, _, alr, clip in grads:
            gq = torch.clamp(grad >> pre_sh, -(1 << 15), 1 << 15)
            m = sh["m_" + wkey] + ((gq - sh["m_" + wkey] + 4) >> 3)
            v = sh["v_" + wkey] + ((gq * gq - sh["v_" + wkey] + 32) >> 6)
            s = (_bits(v) + 1) >> 1                  # ~log2 sqrt(v)
            ratio = torch.clamp((m << 12) >> s, -8192, 8192)
            new[wkey] = torch.clamp(sh[wkey] - ((alr * ratio) >> 12),
                                    -clip, clip)
            new["m_" + wkey] = m
            new["v_" + wkey] = v
    else:
        # mean-over-batch SGD, floor division as in the JAX package
        for wkey, grad, lr, _, clip in grads:
            gq = torch.clamp(grad // (B * W), -G_CLIP, G_CLIP)
            new[wkey] = torch.clamp(sh[wkey] - ((lr * gq) >> 12),
                                    -clip, clip)
    sh = new

    # ---- slide the window start over the oldest ring byte (new params)
    h0, c0, _ = _cell(sh, pb["h0"], pb["c0"], ring[:, 0])
    new_ring = torch.cat([ring[:, 1:], bytes_b[:, None]], dim=1)
    # ---- advance the running state; next-byte distribution
    h_new, c_new, _ = _cell(sh, pb["h"], pb["c"], bytes_b)
    _, vi, total = _softmax_parts(sh, h_new)
    p16 = ((vi.long() << 16) // total.long()).to(I32)        # u32 numerator
    qcum = torch.cat([torch.zeros((B, 1), dtype=I32, device=dev),
                      torch.cumsum(p16, dim=1).to(I32)], dim=1)
    pb = {"h": h_new, "c": c_new, "h0": h0, "c0": c0, "ring": new_ring,
          "qcum": qcum}
    return sh, pb


def _bits(v):
    """Bit length of non-negative int32 values."""
    n = torch.zeros_like(v)
    x = v
    for k in (16, 8, 4, 2, 1):
        big = x >= (1 << k)
        n = n + torch.where(big, k, 0).to(I32)
        x = torch.where(big, x >> k, x)
    return n + (x > 0).to(I32)


# ----------------------------------------------------------- CUDA kernels

LAUNCHES = 3                 # kernels an update: bptt, grads, advance
_KEYS = ("wx", "wh", "wo", "b", "bo")
_CLIPS = (PRE_CLIP, W_CLIP, W_CLIP, PRE_CLIP, PRE_CLIP)
_P5, _I5 = ctypes.c_void_p * 5, ctypes.c_int * 5


class _Args(ctypes.Structure):
    """``IlstmArgs`` of ``csrc/ilstm_update.cu``, field for field."""
    _fields_ = ([(k, _P5) for k in ("w", "m", "v", "nw", "nm", "nv")]
                + [(k, ctypes.c_void_p) for k in (
                    "lut", "ring", "bytes", "h", "c", "h0", "c0", "oh", "oc",
                    "oh0", "oc0", "oring", "oqcum", "scratch")]
                + [(k, ctypes.c_int) for k in (
                    "batch", "hidden", "horizon", "lanes", "bytes64", "adam",
                    "vec")]
                + [(k, _I5) for k in ("lr", "alr", "clip")])


def _set_argtypes(lib):
    lib.ilstm_update.restype = ctypes.c_int
    lib.ilstm_update.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.ilstm_scratch_ints.restype = ctypes.c_longlong
    lib.ilstm_scratch_ints.argtypes = [ctypes.c_int] * 3
    return lib


def _kernel_lib():
    lib = build.load("ilstm_update")
    if not getattr(lib, "_argtypes_set", False):
        _set_argtypes(lib)
        lib._argtypes_set = True
    return lib


_SMS = {}


def _lanes(B, device):
    """Lanes a block of the lane kernels: 1 while the lanes fit on the
    SMs, else 2 (the note in ``csrc/ilstm_update.cu``)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return 1 if B <= _SMS[device] else 2


def _launch(lib, cfg, sh, pb, bytes_b, stream, lanes):
    """Check the operands, allocate the outputs and the scratch stash, and
    launch the chain from ``lib`` (the built ``csrc/ilstm_update.cu``) on
    ``stream`` -> (sh, pb), new tensors."""
    B, H, W = bytes_b.shape[0], cfg.hidden, cfg.horizon
    dev = sh["wh"].device
    shapes = {"wx": (256, 3 * H), "wh": (H, 3 * H), "wo": (H, 256),
              "b": (3 * H,), "bo": (256,)}
    keys = [p + k for p in ("", "m_", "v_")[:3 if cfg.adam else 1]
            for k in _KEYS]
    if set(sh) != set(keys):
        raise ValueError(f"ilstm_update: shared keys {sorted(sh)}, "
                         f"expected {sorted(keys)}")
    lanes_in = [pb[k] for k in ("h", "c", "h0", "c0", "ring")] + [bytes_b]
    build.check_operands(
        "ilstm_update", [sh[k] for k in keys] + lanes_in,
        [shapes[k.split("_")[-1]] for k in keys] + [(B, H)] * 4
        + [(B, W), (B,)], dev,
        [(I32,)] * (len(keys) + 5) + [(torch.int64, I32)])
    new = {k: torch.empty_like(v) for k, v in sh.items()}
    out = {k: torch.empty((B, H), dtype=I32, device=dev)
           for k in ("h", "c", "h0", "c0")}
    out["ring"] = torch.empty((B, W), dtype=I32, device=dev)
    out["qcum"] = torch.empty((B, 257), dtype=I32, device=dev)
    scratch = torch.empty(lib.ilstm_scratch_ints(B, H, W), dtype=I32,
                          device=dev)
    lut = _lut(squash12, ST13_MIN, ST13_MAX, dev)
    ptr = lambda ks: _P5(*(sh[k].data_ptr() for k in ks))     # noqa: E731
    nptr = lambda ks: _P5(*(new[k].data_ptr() for k in ks))   # noqa: E731
    a = _Args(
        w=ptr(_KEYS), nw=nptr(_KEYS),
        m=ptr("m_" + k for k in _KEYS) if cfg.adam else _P5(),
        v=ptr("v_" + k for k in _KEYS) if cfg.adam else _P5(),
        nm=nptr("m_" + k for k in _KEYS) if cfg.adam else _P5(),
        nv=nptr("v_" + k for k in _KEYS) if cfg.adam else _P5(),
        lut=lut.data_ptr(), ring=pb["ring"].data_ptr(),
        bytes=bytes_b.data_ptr(), h=pb["h"].data_ptr(),
        c=pb["c"].data_ptr(), h0=pb["h0"].data_ptr(),
        c0=pb["c0"].data_ptr(), oh=out["h"].data_ptr(),
        oc=out["c"].data_ptr(), oh0=out["h0"].data_ptr(),
        oc0=out["c0"].data_ptr(), oring=out["ring"].data_ptr(),
        oqcum=out["qcum"].data_ptr(), scratch=scratch.data_ptr(),
        batch=B, hidden=H, horizon=W, lanes=lanes,
        bytes64=int(bytes_b.dtype == torch.int64), adam=int(cfg.adam),
        vec=4 if H % 4 == 0 and all(sh[k].data_ptr() % 16 == 0
                                    for k in ("wh", "wo")) else 1,
        lr=_I5(cfg.lr_wx, cfg.lr_wh, cfg.lr_wo, cfg.lr_b, cfg.lr_b),
        alr=_I5(cfg.alr_wx, cfg.alr_wh, cfg.alr_wo, cfg.alr_b, cfg.alr_b),
        clip=_I5(*_CLIPS))
    rc = lib.ilstm_update(ctypes.byref(a), stream)
    if rc != 0:
        raise RuntimeError(f"ilstm_update launch failed: CUDA error {rc}")
    return new, out
