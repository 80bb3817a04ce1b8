"""Milliseconds a byte step while encoding: the Meter's ``device`` phase
(the segments and the waits on the device) over the steps coded, summed
over the window's untraced encode calls."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx["enc"])
    if steps <= 0:
        return None
    return 1e3 * sum(c["phases"].get("device", 0.0)
                     for c in ctx["enc"]) / steps
