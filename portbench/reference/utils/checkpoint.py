"""Engine state on disk: the pretrained dictionary state and its cache.

Counterpart of cmix_tpu/utils/checkpoint.py.  A dictionary's replay
(``engine.make_pretrainer``) runs once per (format, config, gate set,
device type, dictionary) and is cached under ``CACHE_DIR``; every coding
group then starts from a copy of it.  A state is saved leaf by leaf under
its dotted name with ``np.savez`` (no pickle), and loading checks every
name, shape and dtype against a freshly initialized state.
"""

import dataclasses
import hashlib
import os

import numpy as np
import torch

CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "cmix_tpu_torch")


def _leaves(tree, pre=""):
    """[(dotted name, leaf)] of a nested state dict, in key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, f"{pre}{k}.")
        else:
            out.append((pre + k, v))
    return out


def _spec(leaf):
    """(shape, dtype name) of a tensor leaf."""
    return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")


def clone_state(tree):
    """A deep copy: every tensor cloned, so the copy can be updated in place
    while ``tree`` stays as it is."""
    return {k: clone_state(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def save_state(path, state):
    """Write ``state``'s leaves to ``path`` (.npz), atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {name: v.detach().cpu().numpy() for name, v in _leaves(state)}
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path, like):
    """The state saved at ``path``, laid out and placed as ``like``; raises
    ValueError if its leaf names, shapes or dtypes differ from like's."""
    with np.load(path, allow_pickle=False) as z:
        names = [n for n, _ in _leaves(like)]
        if sorted(z.files) != sorted(names):
            raise ValueError(f"checkpoint {path}: leaves "
                             f"{sorted(set(z.files) ^ set(names))} differ")
        arrays = {n: z[n] for n in names}

    def fill(tree, pre=""):
        out = {}
        for k, v in tree.items():
            name = pre + k
            if isinstance(v, dict):
                out[k] = fill(v, name + ".")
                continue
            a = arrays[name]
            if (a.shape, str(a.dtype)) != _spec(v):
                raise ValueError(f"checkpoint {path}: {name} is "
                                 f"{a.shape}/{a.dtype}, the state's "
                                 f"{_spec(v)}")
            out[k] = torch.as_tensor(a, device=v.device)
        return out

    return fill(like)


def pretrain_cache_key(cfg, g, device, dict_bytes, like, wrtw_tables=None):
    """Hex key of a pretrained state: the format version, the config at the
    pretraining segment, the gate record, every leaf's name, shape and
    dtype, the device type (the fast profile's float state differs between
    the CPU and the card), the WRTW tables if any, and the replayed bytes."""
    from portbench.reference.engine import PRETRAIN_SEG
    from portbench.reference.version import FORMAT_VERSION
    h = hashlib.sha256()
    h.update(str(FORMAT_VERSION).encode())
    h.update(repr(dataclasses.replace(cfg, seg_size=PRETRAIN_SEG)).encode())
    h.update(g.blob())
    for name, leaf in _leaves(like):
        h.update(str((name,) + _spec(leaf)).encode())
    h.update(torch.device(device).type.encode())
    for tab in wrtw_tables or ():
        h.update(np.ascontiguousarray(tab, dtype=np.uint32).tobytes())
    h.update(dict_bytes)
    return h.hexdigest()[:24]


def cached_pretrained_state(cfg, g, device, dict_bytes, wrtw_tables=None):
    """The shared state after replaying ``dict_bytes`` from
    ``engine.init_shared``, loaded from ``CACHE_DIR`` or computed and saved
    there.  The caller copies it (``clone_state``) for each coding group."""
    from portbench.reference.engine import init_shared, make_pretrainer
    like = init_shared(cfg, g, device, wrtw_tables)
    key = pretrain_cache_key(cfg, g, device, dict_bytes, like, wrtw_tables)
    path = os.path.join(CACHE_DIR, f"pretrain_{key}.npz")
    if os.path.exists(path):
        return load_state(path, like)
    sh = make_pretrainer(cfg, g, device)(
        like, np.frombuffer(dict_bytes, dtype=np.uint8))
    save_state(path, sh)
    return sh


def dict_fingerprint(dict_bytes):
    """The archive header's 8-byte dictionary fingerprint."""
    return hashlib.sha256(dict_bytes).digest()[:8]
