"""Share of an encode call in which the device ran no byte step, in %:
100 x sum(the call's root span - its replays' device ms) / sum(root
spans), over the window's untraced encode calls.  The root span is
``runner.compress`` from entry to return (host clock); the replays' device
ms are the program's CUDA events (``replay_ms.enc``).  What is left is the
capture, the copy-in, the entry (container, transform, routing), the
group's state and the read-back: time the card spends on no step.  No
tracer runs in these calls, so none of it is the tracer's.  Nothing is
read where no replay was timed."""

from portbench.metrics._program_log import roots, window_meters


def read(ctx):
    root_s = step_s = 0.0
    for m in window_meters(ctx):
        for r in roots(m):
            ms = m.replay_ms.get(r.call)
            if not ms:
                continue
            root_s += r.seconds
            step_s += sum(ms) / 1e3
    if root_s <= 0:
        return None
    return 100.0 * (root_s - step_s) / root_s
