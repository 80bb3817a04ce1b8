"""The stratified sampler: same seed and job, same bytes; B pieces of L
bytes, one from each stratum; the fixed jobs are one pool under every
seed."""

import numpy as np
import pytest

from portbench.harness import traffic

SPEC = traffic.load("mixed.b64")


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 3 * 2**33 + 5, -17])
def test_same_seed_same_bytes(seed):
    a, b = traffic.Jobs(SPEC, seed), traffic.Jobs(SPEC, seed)
    for j in (0, 1, 2, 5):
        assert a.job(j) == b.job(j)
        assert len(a.job(j)) == SPEC["lanes"] * SPEC["piece_bytes"]


def test_pieces_come_one_from_each_stratum():
    jobs = traffic.Jobs(SPEC, 2**31 + 99)
    for j in range(4):
        offs = jobs.offsets(j)
        strata = np.sort(offs // jobs.stratum)
        assert (strata == np.arange(SPEC["lanes"])).all()
        assert ((offs % jobs.stratum) + jobs.piece <= jobs.stratum).all()
        data = jobs.job(j)
        for i, o in enumerate(offs):
            assert data[i * jobs.piece:(i + 1) * jobs.piece] == \
                jobs.corpus[o:o + jobs.piece].tobytes()


def test_fixed_jobs_are_one_pool_under_every_seed():
    pools = []
    for seed in (1, 2, 2**31 + 3):
        jobs = traffic.Jobs(SPEC, seed)
        pools.append(sorted(o for j in range(jobs.fixed)
                            for o in jobs.offsets(j)))
    assert pools[0] == pools[1] == pools[2]
    a, b = traffic.Jobs(SPEC, 1), traffic.Jobs(SPEC, 2)
    assert a.job(0) != b.job(0)          # arranged by the seed
    assert a.job(2) != b.job(2)          # drawn by the seed
