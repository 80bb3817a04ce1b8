"""The JAX package's sharded transcoder (cmix_tpu/parallel/mesh.py) on a
dp=2 x tp=2 mesh of the 8 virtual CPU devices, PORT=1 set as
tests/test_parallel.py sets it, on the input and config of
tests/test_torch_sharded_port.py: its streams are the port's unsharded
streams, so the port's sharded streams (held to the same in that file)
are the JAX package's.  A file of its own: the JAX compile and the port's
ranks then run on different test workers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cmix_tpu import engine as je
from cmix_tpu.parallel.mesh import (
    make_mesh, make_sharded_transcoder, sharded_group_state)
from cmix_tpu_torch import engine as E
from test_torch_sharded_port import B, GATES, blocks, unsharded_streams
from torch_parity import RUNNER_KW

torch.set_num_threads(1)


def test_jax_sharded_portable_equals_port_unsharded():
    assert len(jax.devices()) == 8
    data = blocks(E.EngineConfig(**RUNNER_KW))
    prev = je.gates_blob()
    je.apply_gates(b"PORT=1")
    try:
        cfg = je.EngineConfig(**RUNNER_KW)
        mesh = make_mesh(2, 2)
        trans = make_sharded_transcoder(cfg, mesh)
        sh, pb = sharded_group_state(cfg, B, mesh)
        _, out, lens = trans(sh, pb, jnp.asarray(data),
                             jnp.zeros((B, cfg.comp_size), jnp.uint8),
                             je.MODE_ENCODE)
    finally:
        je.apply_gates(prev)
    out, lens = np.asarray(out), np.asarray(lens)
    got = [out[i, :lens[i]].tobytes() for i in range(B)]
    assert got == unsharded_streams(E.EngineConfig(**RUNNER_KW), GATES, data)
