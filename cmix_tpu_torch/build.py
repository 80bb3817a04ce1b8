"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/cmix_tpu_torch/lib<name>-<source hash>.so`` at the repository root;
the hash covers the ``.cu`` and every ``csrc/*.cuh`` it may include, so an
edited source or header is rebuilt and an unchanged one is reused.  Nothing is
compiled when a module is imported: the CPU tests import every module, and
a machine without a GPU may have no ``nvcc``.  Processes that build one
source at once (the ranks of a sharded run) take turns on a file lock
beside its library: the first builds, the others load its build.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cmix_tpu_torch")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIBS = {}


def _nvcc():
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked at /usr/local/cuda/bin/nvcc "
                       "and PATH)")


def lib_path(name):
    """Where ``csrc/<name>.cu`` builds to (keyed by the content hash of the
    source and of every header in ``csrc/``)."""
    h = hashlib.sha256()
    for src in [name + ".cu"] + sorted(
            f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def compile_source(name, verbose=False):
    """Compile ``csrc/<name>.cu`` unless its build is current; returns
    (path, nvcc output).  Safe to run for several sources at once, and
    from several processes (one builds while the others wait)."""
    out = lib_path(name)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out, ""
        return out, _nvcc_build(name, out, verbose)


def _nvcc_build(name, out, verbose):
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    return res.stdout + res.stderr


def check_operands(name, args, shapes, device, dtypes=None):
    """Raise ValueError unless each tensor of ``args`` is contiguous, on
    ``device``, of its shape in ``shapes`` and of int32 (or of one of its
    entry's ``dtypes``, a tuple per tensor): what a kernel's pointers may
    point at."""
    import torch
    for i, (a, s) in enumerate(zip(args, shapes)):
        ok = dtypes[i] if dtypes else (torch.int32,)
        if (a.device != device or a.dtype not in ok
                or tuple(a.shape) != s or not a.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous {ok[0]} {s} on {device}, "
                f"got {a.dtype} {tuple(a.shape)} on {a.device}")


def load(name):
    """The ctypes handle of the built ``csrc/<name>.cu`` (built on demand)."""
    with _LOCK:
        if name not in _LIBS:
            path, _ = compile_source(name)
            _LIBS[name] = ctypes.CDLL(path)
        return _LIBS[name]
