"""The control: the reference one precision step below what its
configuration states.

* The fast profile states float32 with TF32 off (``engine.resolve_device``
  switches it off).  Its control runs the reference with TF32 on in every
  float32 matrix product (the LSTM's, the mixers' batched dots).
* The portable profile (PORT=1) states int32 arithmetic whose
  contractions are exact in float64 (``utils/intmath.ieinsum``).  Its
  control runs those contractions in float32.

``lower_precision(port)`` switches the reference to its control for the
``with`` block and back after it.
"""

import contextlib

import torch

from portbench.reference import engine, runner
from portbench.reference.mixer import ilstm
from portbench.reference.utils import intmath


def _ieinsum_f32(eq, *ops):
    out = torch.einsum(eq, *(o.float() for o in ops))
    return intmath.wrap32(out.to(torch.int64))


@contextlib.contextmanager
def lower_precision(port):
    if port:
        saved = engine.ieinsum, ilstm.ieinsum
        engine.ieinsum = ilstm.ieinsum = _ieinsum_f32
        try:
            yield
        finally:
            engine.ieinsum, ilstm.ieinsum = saved
        return
    resolve = runner.resolve_device

    def resolve_tf32(device="cuda"):
        dev = resolve(device)
        torch.backends.cuda.matmul.allow_tf32 = True
        return dev

    runner.resolve_device = resolve_tf32
    try:
        yield
    finally:
        runner.resolve_device = resolve
        torch.backends.cuda.matmul.allow_tf32 = False
