"""cmix_tpu_torch: the PyTorch/CUDA port of tpu-cmix.

Same byte-tree context-mixing transcoder and TCMX v19 archive container as
``cmix_tpu``, written as plain PyTorch tensor code with the JAX package's
two TPU kernels hand-written in CUDA C++ for Hopper (``csrc/dmc_fused.cu``,
the DMC apply+walk of the main path, and ``csrc/dmc_counts.cu``, the
prediction-only walk).  The package never imports JAX or ``cmix_tpu``:
host modules it needs are kept as its own copies.

Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU; there is no silent fallback.  The port supports the fast profile
with the default gates and the bench speed profile, and the portable
integer profile (PORT=1), each on the default gates with the
off-by-default mechanisms of ``engine.make_gates`` too, on any content
(with the content-routed gates), with or without a dictionary (WRT and
pretraining; see ``runner``).
"""

from cmix_tpu_torch.version import FORMAT_VERSION  # noqa: F401


def compress(data, cfg=None, **kw):
    """Compress ``data`` (bytes) -> TCMX archive bytes; see
    ``cmix_tpu_torch.runner.compress``."""
    from cmix_tpu_torch.engine import EngineConfig
    from cmix_tpu_torch import runner
    return runner.compress(data, cfg or EngineConfig(), **kw)


def decompress(archive, **kw):
    """Decode a TCMX archive -> original bytes; see
    ``cmix_tpu_torch.runner.decompress``."""
    from cmix_tpu_torch import runner
    return runner.decompress(archive, **kw)
