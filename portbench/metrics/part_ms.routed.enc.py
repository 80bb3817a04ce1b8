"""Device ms of the byte step's content-routed work in a coding group's
last replay: the record grid's contexts, all of them (the four base
columns too, which the default gates compute inside ``predict``, so this
cell's ``predict`` is not the other cells'), where GRID2 or JPEGX widens
them, and the strided LMS's prediction and updates, bracketed by event
nodes that the program captures in its graph only where one of those
gates is on (``engine.ROUTED``; their time is taken out of ``predict`` and
``update``): the median over the window's untraced encode calls (one
group a call, so one sample a call).  Nothing is read on the eager step,
where no routed gate is on, or from a program that times no such part."""

from portbench.metrics._program_log import median, window_meters

PART = "routed"


def read(ctx):
    return median([g[PART] for m in window_meters(ctx)
                   for groups in m.part_ms.values() for g in groups
                   if PART in g])
