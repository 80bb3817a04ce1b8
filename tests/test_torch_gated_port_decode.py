"""The port decodes the JAX package's portable archive with every
off-by-default mechanism the profile allows and JVAL=2, on a recoded JPEG
(the golden ``gated_port_jpeg``; test_torch_gated_port_runner.py holds the
port's encode to the same bytes, and ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-encodes it with the JAX package and
decodes it there)."""

from cmix_tpu_torch import runner as tr
from test_torch_gated_port_runner import jax_archive, jpeg_input


def test_port_decodes_the_jax_packages_archive():
    data = jpeg_input()
    assert tr.decompress(jax_archive(data), device="cpu") == data
