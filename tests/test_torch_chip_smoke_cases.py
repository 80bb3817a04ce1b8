"""The call chip_smoke.py hands ``runner.compress`` on the card for each
golden case it holds the card to (``chip_smoke.GOLDEN_CASES``, read
through tests/golden_cases.py) is the case's entry: its input, config,
gates, environment, ``max_batch`` and dictionary; and the port takes the
gates, a PORT=1 set.  That is the card's call, checked on the CPU without
JAX; test_torch_goldens.py holds each golden file to its entry."""

import pytest

import chip_smoke
from cmix_tpu_torch import engine as E
from golden_cases import goldens, read_parts, sha256


@pytest.mark.parametrize("case", chip_smoke.GOLDEN_CASES)
def test_the_card_codes_the_golden_call(case):
    assert chip_smoke.GOLDEN_CASES.count(case) == 1
    e = goldens()["cases"][case]
    assert e["call"] == "compress"
    data, cfg, kw, env, _ = chip_smoke.golden(case)
    assert sha256(data) == e["input_sha256"]
    assert cfg == E.EngineConfig(**e["config"])
    assert {k: getattr(cfg, k) for k in e["config"]} == e["config"]
    assert set(kw) <= {"gates", "max_batch", "dictionary"}
    assert kw["gates"] == e["gates"] and env == e["env"]
    assert kw.get("max_batch") == e["max_batch"]
    if e["dictionary"] is None:
        assert kw["dictionary"] is None
    else:
        with open(kw["dictionary"], "rb") as f:
            assert f.read() == read_parts(e["dictionary"])
    assert E.make_gates(kw["gates"]).port
