"""The port's kernel build (``cmix_tpu_torch.build``) and sources, checked
without nvcc: a build is keyed by its source and every header, both DMC
kernels share the one warp walk with no CTA barrier, and the LSTM chain's
argument block has the layout its ctypes twin gives it."""

import os
import re
import shutil

import pytest

from cmix_tpu_torch import build

KERNELS = ("dmc_fused", "dmc_counts")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``build`` reads instead."""
    path = tmp_path / "csrc"
    shutil.copytree(build.CSRC, path)
    monkeypatch.setattr(build, "CSRC", str(path))
    return path


def _paths():
    return {k: build.lib_path(k) for k in KERNELS}


def test_lib_path_changes_with_a_header(csrc):
    before = _paths()
    assert before == _paths()
    assert all(os.path.dirname(p) == build.BUILD_DIR for p in before.values())
    with open(csrc / "dmc_walk.cuh", "a") as f:
        f.write("\n// an edit\n")
    after = _paths()
    assert all(after[k] != before[k] for k in KERNELS)
    (csrc / "another.cuh").write_text("#pragma once\n")
    assert all(_paths()[k] != after[k] for k in KERNELS)


def test_lib_path_changes_with_its_own_source_only(csrc):
    before = _paths()
    with open(csrc / "dmc_fused.cu", "a") as f:
        f.write("\n// an edit\n")
    after = _paths()
    assert after["dmc_fused"] != before["dmc_fused"]
    assert after["dmc_counts"] == before["dmc_counts"]


def test_both_kernels_share_the_warp_walk():
    def code(name):
        with open(os.path.join(build.CSRC, name)) as f:
            return re.sub(r"//[^\n]*", "", f.read())
    for name in KERNELS:
        src = code(name + ".cu")
        assert '#include "dmc_walk.cuh"' in src
        assert "dmc::walk(" in src and "__syncthreads" not in src
    walk = code("dmc_walk.cuh")
    assert "__syncwarp()" in walk and "__syncthreads" not in walk


def test_ilstm_args_mirror_the_kernel_struct():
    """``mixer/ilstm._Args`` names the fields of ``IlstmArgs`` in
    ``csrc/ilstm_update.cu`` in its order, arrays of the same length,
    pointers as pointers: ctypes lays the block out as the kernel reads
    it."""
    import ctypes
    from cmix_tpu_torch.mixer.ilstm import _Args
    with open(os.path.join(build.CSRC, "ilstm_update.cu")) as f:
        src = re.sub(r"//[^\n]*", "", f.read())
    body = re.search(r"struct IlstmArgs \{(.*?)\};", src, re.S)[1]
    fields = []
    for decl in body.split(";")[:-1]:
        ctype, names = re.match(r"\s*((?:const )?\w+\**)\s*(.*)",
                                decl.strip(), re.S).groups()
        for name in names.split(","):
            m = re.match(r"\s*(\**)(\w+)(?:\[(\d+)\])?", name)
            ptr = ctype.endswith("*") or bool(m[1])
            fields.append((m[2], int(m[3] or 0), ptr))
    got = []
    for name, ty in _Args._fields_:
        n = getattr(ty, "_length_", 0)
        base = ty._type_ if n else ty
        got.append((name, n, base is ctypes.c_void_p))
    assert got == fields
