"""The transcoder's one-segment pipeline (segment si+1 enqueued before the
host compacts segment si) over several segments per block: the committed
PORT=1 fixtures, the JAX package's archives, come out byte for byte (but
for the header's log2(seg_size)), and the Meter sees every segment."""

import struct

import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils.profiling import Meter
from golden_cases import read_case

LOG_SEG = 4 + 8                  # magic, then the header's 9th byte


@pytest.mark.parametrize("case", ["portable", "routed"])
def test_pipelined_segments_write_the_committed_archive(case):
    e, data, _, ref = read_case(case)
    block = e["config"]["block_size"]
    cfg = E.EngineConfig(**dict(e["config"], seg_size=block // 4))
    meter = Meter()
    arc = runner.compress(data, cfg, max_batch=e["max_batch"],
                          gates=e["gates"], device="cpu", meter=meter)
    assert ref[LOG_SEG] == block.bit_length() - 1
    assert arc[LOG_SEG] == block.bit_length() - 3
    assert arc[:LOG_SEG] + arc[LOG_SEG + 1:] == \
        ref[:LOG_SEG] + ref[LOG_SEG + 1:]
    assert meter.segments == 4                       # one group
    assert set(meter.t) == {"compile", "device", "host"}
    exec_batch = struct.unpack(runner._HDR, ref[4:4 + runner._HDR_LEN])[12]
    assert meter.bytes == exec_batch * block
