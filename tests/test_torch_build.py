"""The port's kernel build (``cmix_tpu_torch.build``) and sources, checked
without nvcc: a build is keyed by its source and every header, and both DMC
kernels share the one warp walk with no CTA barrier."""

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
