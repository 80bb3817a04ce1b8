"""The port decodes the JAX package's portable archive with every
off-by-default mechanism the profile allows and JVAL=2, on a recoded JPEG
(test_torch_gated_port_runner.py holds the port's encode to the same
bytes and has the JAX package decode it)."""

from cmix_tpu_torch import runner as tr
from test_torch_gated_port_runner import jax_archive, jpeg_input


def test_port_decodes_the_jax_packages_archive():
    data = jpeg_input()
    assert tr.decompress(jax_archive(data), device="cpu") == data
