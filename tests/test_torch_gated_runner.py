"""The runner at every off-by-default mechanism of the fast profile
(``utils/profiling.GATED``: SSE2, APM3X, MIX_DYN4, MIX_KIND, MIX_AUX,
SBANK_ADAPT, VMATCH, APM_FIXED, MIX_TAU, MIX_BOOST) against the JAX
package: the same header and gate record, the coded size within
``SIZE_TOL``, and the port's archive decodes exactly."""

from cmix_tpu_torch.utils.profiling import GATED
from torch_parity import SIZE_TOL, check_runner_against_jax


def test_all_fast_mechanisms_match_the_jax_runner():
    assert abs(check_runner_against_jax(GATED)) <= SIZE_TOL
