"""The port's sharded transcoder (parallel/mesh.py) in the portable profile:
4 ranks spawned under Gloo on the CPU, mesh dp=2 x tp=2, 4 lanes of
64-byte text blocks at tests/torch_parity.RUNNER_KW's widths.  Its streams
are the port's unsharded ``make_transcoder`` streams, byte for byte (the
integer profile does not depend on the sharding), and it decodes them
exactly on the mesh.  tests/test_torch_sharded_jax.py holds the unsharded
streams to the JAX package's sharded transcoder."""

import numpy as np
import torch

from cmix_tpu_torch import engine as E
from cmix_tpu_torch.parallel.dryrun import Job, run_mesh
from torch_mp_worker import TIMEOUT
from torch_parity import RUNNER_KW

torch.set_num_threads(1)
B = 4
GATES = {"PORT": 1}


def blocks(cfg, b=B):
    with open("testdata/text100k.raw", "rb") as f:
        data = f.read()[:b * cfg.block_size]
    return np.frombuffer(data, np.uint8).reshape(b, cfg.block_size)


def unsharded_streams(cfg, gates, data):
    """The port's unsharded archive streams of ``data`` on the CPU."""
    g, dev = E.make_gates(gates), torch.device("cpu")
    b = data.shape[0]
    trans = E.make_transcoder(cfg, g, dev)
    _, out, lens = trans(E.init_shared(cfg, g, dev),
                         E.init_perblock(cfg, g, b, dev), data,
                         np.zeros((b, cfg.comp_size), np.uint8),
                         E.MODE_ENCODE)
    return [out[i, :lens[i]].tobytes() for i in range(b)]


def test_portable_mesh_2x2_equals_unsharded():
    cfg = E.EngineConfig(**RUNNER_KW)
    data = blocks(cfg)
    res = run_mesh([Job(data, cfg, GATES)], 2, 2, device="cpu",
                   timeout=TIMEOUT)[0]
    assert res["streams"] == unsharded_streams(cfg, GATES, data)
    assert all(r["roundtrip"] for r in res["ranks"])
    # every replica of the shared state ends the same; each tp slice is
    # the same on both dp ranks that hold it
    dg = {(r["dp"], r["tp"]): r["digests"] for r in res["ranks"]}
    for k in dg[0, 0]:
        for tp in (0, 1):
            assert dg[0, tp][k] == dg[1, tp][k], k
    assert dg[0, 0]["ppm"] != dg[0, 1]["ppm"]
    assert dg[0, 0]["w1"] == dg[0, 1]["w1"]
    # the collectives of one rank's step: 2 all-gathers over dp (the
    # update's inputs, the arena writes), the tp reads over tp
    enc = res["ranks"][0]["encode"]
    assert enc["gathers"] == 2 and enc["reduces"] >= 8
