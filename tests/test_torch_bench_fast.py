"""The port's bench (``cmix_tpu_torch/bench.py``) in the fast profile:
``run`` on 4 blocks of bench4m.raw at small widths, two segments a block,
with the bench gates decodes exactly, re-encodes identically, and codes
within ``torch_parity.SIZE_TOL`` (1%, PERF.md section 2) of ``cmix_tpu``'s
transcoder driven as ``bench.py`` drives it (the golden ``bench_fast``;
``RUN_SLOW=1 pytest tests/test_torch_goldens.py`` re-derives it)."""

from cmix_tpu_torch import bench
from cmix_tpu_torch.engine import BENCH_GATES, EngineConfig
from torch_parity import BENCH_KW, SIZE_TOL, bench_blocks, jax_golden_streams


def test_fast_bench_round_trip_and_size():
    data = bench_blocks()
    r = bench.run(data, EngineConfig(**BENCH_KW), BENCH_GATES, "cpu")
    assert r["roundtrip"] and r["reencode_identical"] and r["fits"]
    assert r["ok"]
    _, len_j = jax_golden_streams("bench_fast", data, config=BENCH_KW,
                                  gates=BENCH_GATES)
    coded_j = int(len_j.sum())
    assert abs(r["coded_bytes"] - coded_j) <= SIZE_TOL * coded_j, (
        r["coded_bytes"], coded_j)
