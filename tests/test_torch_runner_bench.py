"""The port's archive container against the JAX package's, bench speed
profile gates (DMC_LEVELS=7 PPM_CK=0 PPM_DEEP=0 BANK_CH=1 CTX4=0).  The
JAX package's archive is the golden ``runner_bench``; ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-derives it."""

from cmix_tpu_torch.engine import BENCH_GATES
from torch_parity import check_runner_against_jax


def test_runner_matches_jax_bench_gates():
    check_runner_against_jax("runner_bench", BENCH_GATES)
