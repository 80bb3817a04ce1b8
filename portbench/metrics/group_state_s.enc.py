"""Seconds an encode call spends building its coding groups' initial
state (``runner._group_state``: the shared tables, the float LSTM's
initial weights, the per-lane state): the ``group_state`` spans, summed
per call and averaged over the window's untraced encode calls."""

from portbench.metrics._program_log import window_meters


def read(ctx):
    meters = window_meters(ctx)
    calls = sum(1 for m in meters for s in m.spans if s.parent is None)
    if not calls:
        return None
    return sum(s.seconds for m in meters for s in m.spans
               if s.name == "group_state") / calls
