"""Both packages' CLIs under SSE2=1 in the environment: the same gate
record, and each archive decodes in a clean environment (the bench gates:
test_torch_env_gates.py)."""

from test_torch_env_gates import check_env_gates


def test_sse2_from_the_environment(tmp_path):
    check_env_gates(tmp_path, {"SSE2": 1})
