"""The one traffic generator: stratified pieces of a corpus, by seed.

A traffic mix is a data file (``portbench/traffic/<name>.json``) of
parameters this module reads:

* ``corpus``: the file the pieces are cut from, relative to ``portbench/``;
* ``lanes``: how many pieces make one job, one from each of ``lanes``
  equal strata of the corpus, so every job holds the same mix of content;
* ``piece_bytes``: the length of a piece (a job is ``lanes`` x
  ``piece_bytes`` bytes, concatenated);
* ``fixed_jobs``: the first jobs of every run take their pieces from a
  fixed pool, ``fixed_jobs`` pieces a stratum at evenly spaced offsets;
  the seed decides only which job gets which piece of each stratum and
  the order of the pieces in a job.  So these jobs' bytes are the same set
  under every seed, and a metric over them (``bpb``) does not swing with
  the seed's choice of content.  Later jobs draw every piece's offset
  from the seed and the job's index.

``job(j)`` gives the same bytes for the same seed and index, in any
process.
"""

import json
import os

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("corpus", "lanes", "piece_bytes", "fixed_jobs")


def load(name, bench_dir=BENCH_DIR):
    """The traffic mix ``name``'s parameters (``traffic/<name>.json``)."""
    with open(os.path.join(bench_dir, "traffic", name + ".json")) as f:
        spec = json.load(f)
    missing = [k for k in KEYS if k not in spec]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    return spec


def _rng(seed, *tags):
    # any whole seed, negative or past 64 bits, maps to one stream
    return np.random.default_rng([seed % (1 << 64), *tags])


class Jobs:
    """The jobs of one run: ``job(j)`` -> bytes."""

    def __init__(self, spec, seed, bench_dir=BENCH_DIR):
        self.lanes = int(spec["lanes"])
        self.piece = int(spec["piece_bytes"])
        self.fixed = int(spec["fixed_jobs"])
        self.seed = seed
        self.corpus = np.fromfile(os.path.join(bench_dir, spec["corpus"]),
                                  dtype=np.uint8)
        self.stratum = len(self.corpus) // self.lanes
        if self.stratum < self.piece:
            raise ValueError("corpus too short for its strata")
        span = self.stratum - self.piece
        k = np.arange(self.fixed)
        # the pool: fixed_jobs evenly spaced pieces of each stratum
        self.pool = (np.arange(self.lanes)[:, None] * self.stratum
                     + ((2 * k + 1) * span // (2 * max(self.fixed, 1)))
                     [None, :])
        rng = _rng(seed, 0)
        self.pool_perm = np.stack([rng.permutation(self.fixed)
                                   for _ in range(self.lanes)])

    def offsets(self, j):
        """Each piece's offset in the corpus, in the job's lane order."""
        rng = _rng(self.seed, 1, j)
        if j < self.fixed:
            offs = self.pool[np.arange(self.lanes), self.pool_perm[:, j]]
        else:
            offs = (np.arange(self.lanes) * self.stratum
                    + rng.integers(0, self.stratum - self.piece + 1,
                                   size=self.lanes))
        return offs[rng.permutation(self.lanes)]

    def job(self, j):
        offs = self.offsets(j)
        return b"".join(self.corpus[o:o + self.piece].tobytes()
                        for o in offs)
