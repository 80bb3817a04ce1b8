"""Seconds of the graph's warm-up and capture per encode call: the Meter's
``compile`` phase, averaged over the window's untraced encode calls (every
call builds its transcoder and captures anew)."""


def read(ctx):
    calls = [c for c in ctx["enc"] if "compile" in c["phases"]]
    if not calls:
        return None
    return sum(c["phases"]["compile"] for c in calls) / len(calls)
