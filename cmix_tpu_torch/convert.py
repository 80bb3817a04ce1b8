"""Carry engine state between the JAX package and the port.

``from_jax_state(sh, pb, cd)`` takes the JAX package's state pytrees as
numpy arrays (the caller runs ``jax.device_get``) and returns the port's
tensors: uint32 tables become int32 tensors holding the same bits, small
u32 leaves (and the WRTW=2 codeword tables ``wrtw_word``/``wrtw_stem``)
become int64 values, the bank chunks ``bank``/``bank2``/... are
joined into one table, the DMC tables' TPU tile layout (B, N/1024, 8, 128)
becomes flat (B, N).  The portable profile's integer tables and the
integer LSTM's leaves stay int32, as the port computes them; float32 leaves
(the fast profile's tables, the strided LMS's ``lms_conf``, ``lms_w`` and
``lms_err``, SBANK_ADAPT's ``sbank_c``) and uint8 leaves (JVAL's ``jval``
and ``jval2``) pass as they are, and the per-block segment-table fields
(``rec_forced``, ``blk_kind``, ``jpeg_rel0``, ``jpeg_clen``) become int64.
``to_numpy`` is the inverse, so tests can compare the two packages leaf
by leaf.
"""

import numpy as np
import torch

from cmix_tpu_torch.engine import resolve_device

# uint32 leaves kept at rest as int32 bits in the port
_BITS32 = {"d12", "aux_tbl", "ppm", "sbank", "bank", "dmc_nxt", "dmc_cnt",
           "dmc_uXC", "dmc_uSW", "dmc_uUW"}
# int32 leaves the port keeps as int32: kernel operands, small tables, and
# the portable profile's integer domains of the fast profile's f32 tables,
# and the float LSTM's Adam step count
_INT32 = {"step", "ppm_ck", "dmc_cur", "dmc_top", "dmc_uX", "dmc_uS",
          "dmc_uU", "d0_p", "d0_c", "match_conf", "match2_conf", "runx_conf",
          "ppm_see", "sbank_p", "w1", "bias1", "w2", "w2b", "w2c", "w2x",
          "bias2", "w3", "bias3", "apm", "w_apm", "w_sse"}
# uint32 leaves held as int64 u32 values (the WRTW=2 codeword tables too)
_U32_SMALL = {"ind_val", "h32", "h48", "x1", "x2", "xc", "wrtw_word",
              "wrtw_stem"}
_U32_TREES = {"ctx", "x86"}
_SEP = 64                          # the JAX package's BANK_SPLIT


def _leaf_to_torch(key, a, device, keep32=False):
    a = np.asarray(a)
    if key in ("dmc_nxt", "dmc_cnt") and a.ndim == 4:
        a = a.reshape(a.shape[0], -1)
    if a.dtype == np.uint32:
        if key in _BITS32:
            return torch.as_tensor(a.view(np.int32).copy(), device=device)
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype == np.int32 and not (keep32 or key in _INT32):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.copy(), device=device)


def _all_int32(tree):
    """An integer LSTM's state (the PORT profile): every leaf int32."""
    return all(_all_int32(v) if isinstance(v, dict)
               else np.asarray(v).dtype == np.int32 for v in tree.values())


def _tree_to_torch(tree, device, keep32=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tree_to_torch(v, device,
                                    keep32 or (k == "lstm" and _all_int32(v)))
        else:
            out[k] = _leaf_to_torch(k, v, device, keep32)
    return out


def from_jax_state(sh, pb, cd, device="cuda"):
    """JAX-package state (numpy pytrees) -> the port's (sh, pb, cd) on
    ``device`` (the card by default, as every entry point: raises without
    one; "cpu" when asked)."""
    device = resolve_device(device)
    sh = dict(sh)
    chunks = sorted((k for k in sh if k.startswith("bank")
                     and k[4:].isdigit() or k == "bank"),
                    key=lambda k: int(k[4:] or 1))
    if chunks:
        sh["bank"] = np.concatenate([np.asarray(sh.pop(k)) for k in chunks],
                                    axis=0)
    return (_tree_to_torch(sh, device), _tree_to_torch(pb, device),
            _tree_to_torch(cd, device))


def _leaf_to_numpy(key, t, u32_tree):
    a = t.detach().cpu().numpy()
    if key in _BITS32:
        return a.view(np.uint32) if a.dtype == np.int32 else a
    if u32_tree or key in _U32_SMALL:
        return a.astype(np.uint32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def _tree_to_numpy(tree, u32_tree=False):
    return {k: (_tree_to_numpy(v, k in _U32_TREES) if isinstance(v, dict)
                else _leaf_to_numpy(k, v, u32_tree))
            for k, v in tree.items()}


def to_numpy(sh, pb, cd):
    """The port's (sh, pb, cd) -> numpy pytrees in the JAX package's
    dtypes and key layout (bank split in 64-model chunks; DMC tables flat
    (B, N) -- reshape the JAX side's tile layout to compare)."""
    sh = _tree_to_numpy(sh)
    bank = sh.pop("bank", None)
    for i, lo in enumerate(range(0, 0 if bank is None else bank.shape[0],
                                 _SEP)):
        sh["bank" if i == 0 else f"bank{i + 1}"] = bank[lo:lo + _SEP]
    return sh, _tree_to_numpy(pb), _tree_to_numpy(cd)
