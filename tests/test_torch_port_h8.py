"""The portable profile at LSTM horizon 8 (the CLI's window above 256 KiB
of input) across the two packages on the CPU, held by the committed
``testdata/portable_h8.tcmx`` (the JAX package's PORT=1 archive of
``testdata/portable.raw`` at ``chip_smoke.PORT_H8_SMALL``, the golden
``portable_h8``) that chip_smoke.py decodes and re-encodes on the card:
the port writes those bytes and decodes them.  The two archives being
equal, that is also the cross-decode.  ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-encodes the input with the JAX package
and decodes the archive there.

To rewrite the archive after a deliberate format change:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_parity.py
--write-goldens portable_h8``."""

import struct

import chip_smoke
import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import engine as E
from cmix_tpu_torch import runner
from torch_parity import jax_golden


def test_h8_fixture_is_written_and_decoded_by_both_packages():
    with open(chip_smoke.PORT_FIXTURE, "rb") as f:
        data = f.read()
    with open(chip_smoke.PORT_H8_ARCHIVE, "rb") as f:
        ref = f.read()
    fields = struct.unpack(runner._HDR, ref[4:4 + runner._HDR_LEN])
    assert fields[10] == 8                      # the header's lstm_horizon
    arc = jax_golden("portable_h8", data, config=chip_smoke.PORT_H8_SMALL,
                     gates={"PORT": 1}, max_batch=chip_smoke.PORT_BATCH)
    assert arc == ref
    cfg = E.EngineConfig(**chip_smoke.PORT_H8_SMALL)
    assert runner.compress(data, cfg, max_batch=chip_smoke.PORT_BATCH,
                           gates={"PORT": 1}, device="cpu") == ref
    assert runner.decompress(ref, device="cpu") == data
