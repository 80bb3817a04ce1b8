"""Device ms of the byte step's ``predict`` part (the contexts' keys, the
tree's prediction and the p16 clamp) in a coding group's last replay, timed
by event nodes that the program captures in its graph (``engine.PARTS``):
the median over the window's untraced encode calls (one group a call, so
one sample a call).  Nothing is read on the eager step or from a program
that times no part."""

from portbench.metrics._program_log import median, window_meters

PART = "predict"


def read(ctx):
    return median([g[PART] for m in window_meters(ctx)
                   for groups in m.part_ms.values() for g in groups
                   if PART in g])
