"""The sharded byte step the graph captures, run eagerly on the CPU.

* On a dp=2 x tp=2 mesh of Gloo ranks (``parallel/dryrun.run_mesh``, one
  start of the ranks for both profiles): torch_mp_worker.STATIC_STEPS
  steps of ``engine.make_static_step(cfg, g, cpu, comm)`` equal the eager
  sharded step (``make_byte_step(..., comm)``) on every leaf of every rank,
  in PORT=1 and in the fast profile, and no static buffer changes its
  storage; a graph asked for under Gloo raises ValueError.
* The ranks' state digests are taken from the state after coding: with a
  segment runner that copies a group's state in, as the graph does for a
  later group of its width, the decode's digests are those of the state
  after the decode (the encode's: the decode replays its updates), not
  those of the fresh state handed in.
"""

import os

import numpy as np
import pytest
import torch

from cmix_tpu_torch import engine as E
from cmix_tpu_torch.parallel import dryrun
from cmix_tpu_torch.parallel.distributed import Mesh
from cmix_tpu_torch.parallel.mesh import sharded_group_state, state_digests
from cmix_tpu_torch.utils.checkpoint import clone_state
from test_torch_sharded_port import blocks
from torch_mp_worker import STATIC_STEPS, TIMEOUT
from torch_parity import RUNNER_KW

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_static_sharded_body_equals_the_eager_sharded_step(monkeypatch):
    # the ranks import the rank function from this directory
    here = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    cfg = E.EngineConfig(**RUNNER_KW)
    data = blocks(cfg)
    res = dryrun.run_mesh([dryrun.Job(data, cfg, gates, decode=False)
                           for gates in ({"PORT": 1}, {})], 2, 2,
                          device="cpu", timeout=TIMEOUT,
                          rank_fn="torch_mp_worker:static_body_job")
    for r in res:
        assert r["streams"] is None
        for rank in r["ranks"]:
            assert rank["differ"] == [], rank
            assert rank["storage_kept"] and rank["t"] == STATIC_STEPS
            assert rank["leaves"] > 100
            assert rank["gloo_graph_refused"] == [True, True]


class _CopyIn(E._Segments):
    """The eager segment runner, starting each group as the graph starts a
    later group of its width: the state handed in is copied in, and its
    tensors keep their values."""

    given = []

    def start(self, sh, pb, cd, comp, mode):
        self.given.append(state_digests(sh))
        super().start(clone_state(sh), clone_state(pb), clone_state(cd),
                      comp, mode)


@pytest.mark.parametrize("gates", [{"PORT": 1}, {}])
def test_digests_are_the_state_after_coding(gates, monkeypatch):
    monkeypatch.setattr(E, "make_segment_fn",
                        lambda *a: _CopyIn(*a))
    monkeypatch.setattr(_CopyIn, "given", [])
    cfg = E.EngineConfig(**dict(RUNNER_KW, block_size=16, seg_size=16))
    g, data = E.make_gates(gates), blocks(cfg, 2)
    fresh = state_digests(sharded_group_state(cfg, g, 2, Mesh(1, 1, 0),
                                              CPU)[0])
    rep = dryrun.code_job(cfg, g, data, Mesh(1, 1, 0), CPU,
                          dict(decode=True))
    assert rep["roundtrip"] and not rep["graph"]
    assert _CopyIn.given == [fresh, fresh]
    dec = rep["decode"]["digests"]
    assert dec == rep["digests"]
    changed = [k for k in fresh if dec[k] != fresh[k]]
    assert {"w1", "bank", "aux_tbl"} <= set(changed), changed
    out, lens = rep["streams"]
    assert np.all(lens > 4)
