"""LSTM byte mixer: a recurrent 256-way byte model trained online.

Port of cmix_tpu/mixer/lstm.py (fast profile): fused-gate stacked LSTM
with per-gate layer norm, ONE weight set shared by all B blocks, truncated
BPTT over a ring of the last ``horizon`` bytes (a Python loop under
``torch.autograd``), Adam with gradients clipped to +-10.

Initial weights are the JAX package's ``jax.random.normal`` draws under
``PRNGKey(0x1234)``, reproduced in numpy (threefry2x32 with JAX's default
partitionable counter layout, the uniform-bits map and XLA's float32
``erf_inv``), so no weight file ships.

Determinism on the card: the byte embedding is a one-hot matmul and the
loss picks the target's log-probability with a one-hot product, so the
backward pass has no scatter-add with duplicate indices (a float atomic on
CUDA); everything else is GEMMs and elementwise ops.
"""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.utils.ops import cumsum0_last


@dataclass(frozen=True)
class LstmConfig:
    hidden: int = 256
    layers: int = 2
    horizon: int = 8
    lr: float = 2e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6


# ------------------------------------------- jax.random.normal in numpy

_M32 = np.uint64(0xFFFFFFFF)


def _rotl(x, d):
    return ((x << np.uint64(d)) | (x >> np.uint64(32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) as XLA lowers it; uint32 arrays."""
    k1, k2 = np.uint64(k1), np.uint64(k2)
    x = [x1.astype(np.uint64), x2.astype(np.uint64)]
    ks = [k1, k2, k1 ^ k2 ^ np.uint64(0x1BD11BDA)]
    rots = [(13, 15, 26, 6), (17, 29, 16, 24)]
    x[0] = (x[0] + ks[0]) & _M32
    x[1] = (x[1] + ks[1]) & _M32
    for i in range(5):
        for r in rots[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x[0].astype(np.uint32), x[1].astype(np.uint32)


def _counters(n):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), \
        (i & _M32).astype(np.uint32)


def prng_key(seed):
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    dtype=np.uint32)


def split(key, num):
    """jax.random.split under the partitionable threefry layout."""
    b1, b2 = threefry2x32(key[0], key[1], *_counters(num))
    return np.stack([b1, b2], axis=1)


def _erf_inv_f32(x):
    """XLA's float32 erf_inv (Giles' single-precision approximation)."""
    f = np.float32
    lt5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
    ge5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)
    # log1p in float64 rounded once, and c + p*w as a fused multiply-add
    # (float64 product and sum, one rounding) -- as XLA's CPU code emits
    w = (-np.log1p((-x * x).astype(np.float64))).astype(f)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
    p = np.where(lt, f(lt5[0]), f(ge5[0])).astype(f)
    for a, b in zip(lt5[1:], ge5[1:]):
        c = np.where(lt, f(a), f(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)).astype(f)
    return np.where(np.abs(x) == f(1), x * np.finfo(f).max, p * x).astype(f)


def normal(key, shape):
    """jax.random.normal(key, shape, float32) in numpy."""
    n = int(np.prod(shape))
    b1, b2 = threefry2x32(key[0], key[1], *_counters(n))
    bits = b1 ^ b2
    f = np.float32
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(f) - f(1)
    lo = np.nextafter(f(-1.0), f(0.0), dtype=f)
    u = np.maximum(lo, floats * (f(1.0) - lo) + lo).astype(f)
    return (f(np.sqrt(2)) * _erf_inv_f32(u)).reshape(shape).astype(f)


# ------------------------------------------------------------------ model


def init_lstm_shared(cfg: LstmConfig, device, seed: int = 0x1234):
    h, L = cfg.hidden, cfg.layers
    k1, k2, k3, k4 = split(prng_key(seed), 4)
    scale = np.float32(1.0 / np.sqrt(h))
    f32 = np.float32
    params = {
        "wx": normal(k1, (256, 3 * h)) * f32(0.08),
        "wh": normal(k2, (L, h, 3 * h)) * scale,
        "wi": normal(k4, (L, h, 3 * h)) * scale,
        "b": np.zeros((L, 3 * h), f32),
        "wo": normal(k3, (L * h, 256)) * scale,
        "bo": np.zeros(256, f32),
    }
    params = {k: torch.as_tensor(v, device=device) for k, v in params.items()}
    opt = {"m": {k: torch.zeros_like(v) for k, v in params.items()},
           "v": {k: torch.zeros_like(v) for k, v in params.items()},
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    return {"params": params, "opt": opt}


def init_lstm_perblock(cfg: LstmConfig, B, device):
    z = torch.zeros((B, cfg.layers, cfg.hidden), dtype=torch.float32,
                    device=device)
    return {"h": z, "c": z.clone(), "h0": z.clone(), "c0": z.clone(),
            "ring": torch.zeros((B, cfg.horizon), dtype=torch.int64,
                                device=device),
            "qcum": (torch.arange(257, dtype=torch.float32, device=device)
                     * (65536.0 / 256.0)).repeat(B, 1)}


def _onehot(idx, n=256):
    return (idx[:, None] == torch.arange(n, device=idx.device)[None, :]
            ).float()


def _ln_b(x):
    """Per-gate layer norm, batched: x (B, 3, H)."""
    m = x.mean(dim=2, keepdim=True)
    v = torch.square(x - m).mean(dim=2, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5)


def _stack_cell_b(params, h, c, bytes_b):
    """One stacked fused-gate step: h, c (B, L, H), bytes_b (B,) int64."""
    B, L, H = h.shape
    x = _onehot(bytes_b) @ params["wx"]                      # (B, 3H)
    hs, cs = [], []
    for lay in range(L):
        if lay > 0:
            x = hs[-1] @ params["wi"][lay]
        pre = x + h[:, lay] @ params["wh"][lay] + params["b"][lay][None]
        pre = _ln_b(pre.reshape(B, 3, H)).reshape(B, 3 * H)
        f = torch.sigmoid(pre[:, :H])
        g = torch.tanh(pre[:, H:2 * H])
        o = torch.sigmoid(pre[:, 2 * H:])
        c_new = f * c[:, lay] + (1.0 - f) * g
        hs.append(o * torch.tanh(c_new))
        cs.append(c_new)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def _logits_b(params, h):
    return h.reshape(h.shape[0], -1) @ params["wo"] + params["bo"][None]


# Adam's bias corrections 1 - beta^t stop changing in float32 once beta^t
# is below half an ulp of 1: from t = 165 for beta1 = 0.9, t = 17321 for
# beta2 = 0.999 (numpy float32 pow; tests/test_torch_graph_adam.py)
BC_STEPS = 17321
_BC = {}


def bias_correction(beta, t):
    """``1 - beta**t`` as numpy's float32 scalar pow rounds it."""
    f32 = np.float32
    return f32(1) - f32(beta) ** f32(t)


def bias_table(cfg: LstmConfig, device):
    """(BC_STEPS, 2) float32 table of Adam's bias corrections
    ``1 - beta1**t``, ``1 - beta2**t`` for t = 1..BC_STEPS, computed once
    with numpy's float32 pow and kept on ``device``.  The step reads it
    with the step count clamped at BC_STEPS, so the corrections are device
    values (a captured step replays them) with the host's rounding."""
    key = (cfg.beta1, cfg.beta2, str(device))
    if key not in _BC:
        _BC[key] = torch.as_tensor(np.array(
            [[bias_correction(b, t) for b in (cfg.beta1, cfg.beta2)]
             for t in range(1, BC_STEPS + 1)], dtype=np.float32),
            device=device)
    return _BC[key]


def bias_corrections(cfg: LstmConfig, step):
    """(bc1, bc2) 0-d float32 tensors for the 0-d int32 step count."""
    tbl = bias_table(cfg, step.device)
    i = (torch.clamp(step, max=BC_STEPS) - 1).long().view(1)
    bc = tbl.index_select(0, i)[0]
    return bc[0], bc[1]


def lstm_shared_byte_update(cfg: LstmConfig, sh, pb, bytes_b):
    """One Adam step on the shared params from the horizon-replayed loss,
    then advance every block and cache next-byte distributions.
    Returns new (sh, pb) dicts; bytes_b (B,) int64."""
    params, opt = sh["params"], sh["opt"]
    ring = pb["ring"]
    targets = torch.cat([ring[:, 1:], bytes_b[:, None]], dim=1)
    keys = list(params)
    with torch.enable_grad():
        p = {k: params[k].detach().requires_grad_(True) for k in keys}
        h, c = pb["h0"], pb["c0"]
        nlls = []
        for i in range(cfg.horizon):
            h, c = _stack_cell_b(p, h, c, ring[:, i])
            lse = torch.log_softmax(_logits_b(p, h), dim=1)
            nlls.append(-torch.mean((lse * _onehot(targets[:, i])).sum(1)))
        loss = torch.mean(torch.stack(nlls))
        grads = torch.autograd.grad(loss, [p[k] for k in keys])

    step = opt["step"] + 1
    bc1, bc2 = bias_corrections(cfg, step)
    new_p, new_m, new_v = {}, {}, {}
    for k, g in zip(keys, grads):
        g = torch.clamp(g, -10.0, 10.0)
        m = cfg.beta1 * opt["m"][k] + (1 - cfg.beta1) * g
        v = cfg.beta2 * opt["v"][k] + (1 - cfg.beta2) * g * g
        new_m[k], new_v[k] = m, v
        new_p[k] = params[k] - cfg.lr * (m / bc1) / (
            torch.sqrt(v / bc2) + cfg.eps)

    h0, c0 = _stack_cell_b(new_p, pb["h0"], pb["c0"], ring[:, 0])
    new_ring = torch.cat([ring[:, 1:], bytes_b[:, None]], dim=1)
    h_new, c_new = _stack_cell_b(new_p, pb["h"], pb["c"], bytes_b)
    q = torch.softmax(_logits_b(new_p, h_new), dim=1) * 65536.0
    sh = {"params": new_p, "opt": {"m": new_m, "v": new_v, "step": step}}
    pb = {"h": h_new, "c": c_new, "h0": h0, "c0": c0, "ring": new_ring,
          "qcum": cumsum0_last(q)}
    return sh, pb
