"""Dictionary mode in the fast profile on the CPU (the input, widths and
groups of tests/test_torch_dict_runner.py): the port's archive has the JAX
package's header, gate record and segment table, its size is within
SIZE_TOL of the JAX package's, and it round-trips; decoding and a second
encode load the pretrained state from the cache (the pretrainer does not
run again) and the re-encode is byte-identical."""

import os
import struct

from cmix_tpu import engine as je
from cmix_tpu.utils import checkpoint as jck
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils import checkpoint
from test_torch_dict_runner import DIC, dict_input
from torch_parity import RUNNER_KW, SIZE_TOL, jax_runner_gates


def test_fast_dict_archive_round_trips_and_reuses_the_cache(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(jck, "CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(checkpoint, "CACHE_DIR", str(tmp_path / "port"))
    data = dict_input()
    with jax_runner_gates({}) as jr:
        aj = jr.compress(data, je.EngineConfig(**RUNNER_KW), max_batch=3,
                         dictionary=DIC)
    cfg = E.EngineConfig(**RUNNER_KW)
    at = runner.compress(data, cfg, max_batch=3, dictionary=DIC,
                         device="cpu")
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", at[off:off + 2])[0]
    end = off + 2 + glen
    assert at[:end] == aj[:end]              # header, fingerprint, gates
    assert at[off + 2:end] == b"WRTW=1" and at[5] == 3
    assert runner._read_seg_table(at, end) == runner._read_seg_table(aj, end)
    gap = (len(at) - len(aj)) / len(aj)
    assert abs(gap) <= SIZE_TOL, (len(at), len(aj))
    assert len(os.listdir(tmp_path / "port")) == 1

    def no_replay(*args):
        raise AssertionError("the pretrainer ran on a cache hit")
    monkeypatch.setattr(E, "make_pretrainer", no_replay)
    assert runner.decompress(at, dictionary=DIC, device="cpu") == data
    assert runner.compress(data, cfg, max_batch=3, dictionary=DIC,
                           device="cpu") == at
