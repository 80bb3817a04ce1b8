"""The port's bench (``cmix_tpu_torch/bench.py``) in the portable profile:
``run`` on 4 blocks of bench4m.raw at small widths, two segments a block,
the bench gates and PORT=1 writes in its timed encode the streams
``cmix_tpu``'s transcoder writes when driven as ``bench.py`` drives it,
byte for byte (the golden ``bench_port``; ``RUN_SLOW=1 pytest
tests/test_torch_goldens.py`` re-derives it); the first encode equals it
and the decode is exact."""

import numpy as np

from cmix_tpu_torch import bench
from cmix_tpu_torch.engine import BENCH_GATES, EngineConfig
from torch_parity import BENCH_KW, bench_blocks, jax_golden_streams


def test_portable_bench_streams_are_the_jax_packages():
    env = dict(BENCH_GATES, PORT=1)
    data = bench_blocks()
    r = bench.run(data, EngineConfig(**BENCH_KW), env, "cpu")
    assert r["roundtrip"] and r["reencode_identical"] and r["fits"]
    assert r["ok"]
    out, out_len = r["streams"]
    out_j, len_j = jax_golden_streams("bench_port", data, config=BENCH_KW,
                                      gates=env)
    assert np.array_equal(out_len, len_j)
    assert np.array_equal(out, bench._streams(out_j, len_j))
    assert r["coded_bytes"] == int(len_j.sum())
    assert r["bpb"] == 8.0 * r["coded_bytes"] / len(data)
    assert (r["blocks"], r["steps"]) == (4, BENCH_KW["block_size"])
    # each pass went through the pipeline: two segments of the one group
    for label in ("first", "encode", "decode"):
        m = r["meters"][label]
        assert m["segments"] == 2 and m["bytes"] == len(data)
        assert m["out_bytes"] == r["coded_bytes"]
        assert r["passes"][label]["s"] > 0
