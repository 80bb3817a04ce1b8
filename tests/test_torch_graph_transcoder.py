"""The transcoder's one-segment pipeline (segment si+1 enqueued before the
host compacts segment si) over several segments per block: the committed
PORT=1 fixtures, the JAX package's archives, come out byte for byte (but
for the header's log2(seg_size)), and the Meter sees every segment."""

import struct

import pytest

import chip_smoke
import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from cmix_tpu_torch.utils.profiling import Meter

LOG_SEG = 4 + 8                  # magic, then the header's 9th byte


@pytest.mark.parametrize("fixture,archive,small,batch", [
    (chip_smoke.PORT_FIXTURE, chip_smoke.PORT_ARCHIVE, chip_smoke.PORT_SMALL,
     chip_smoke.PORT_BATCH),
    (chip_smoke.ROUTED_FIXTURE, chip_smoke.ROUTED_ARCHIVE,
     chip_smoke.ROUTED_SMALL, chip_smoke.ROUTED_BATCH)],
    ids=["portable", "routed"])
def test_pipelined_segments_write_the_committed_archive(fixture, archive,
                                                        small, batch):
    with open(fixture, "rb") as f:
        data = f.read()
    with open(archive, "rb") as f:
        ref = f.read()
    block = small["block_size"]
    cfg = E.EngineConfig(**dict(small, seg_size=block // 4))
    meter = Meter()
    arc = runner.compress(data, cfg, max_batch=batch, gates={"PORT": 1},
                          device="cpu", meter=meter)
    assert ref[LOG_SEG] == block.bit_length() - 1
    assert arc[LOG_SEG] == block.bit_length() - 3
    assert arc[:LOG_SEG] + arc[LOG_SEG + 1:] == \
        ref[:LOG_SEG] + ref[LOG_SEG + 1:]
    assert meter.segments == 4                       # one group
    assert set(meter.t) == {"compile", "device", "host"}
    exec_batch = struct.unpack(runner._HDR, ref[4:4 + runner._HDR_LEN])[12]
    assert meter.bytes == exec_batch * block
