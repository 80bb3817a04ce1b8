"""95th percentile of the device ms of a graph replay while encoding: the
samples of ``replay_ms.enc`` (512 an encode call, about 2,300 over a 51 s
window), the percentile by linear interpolation between the closest ranks
(numpy's default).  The step runs at one of two paces on the device
(PERF.md §5); this is where the slow pace shows."""

import numpy as np

from portbench.metrics._program_log import replay_samples, window_meters


def read(ctx):
    xs = replay_samples(window_meters(ctx))
    return float(np.percentile(xs, 95)) if xs else None
