"""The program's own records of the window's encode calls, for the readers
of spans and device events (``replay_ms.enc``, ``off_step_share.enc``,
``group_state_s.enc``, ``part_ms.<part>.enc``).

The program keeps the ``Meter`` of each of its last finished
``compress``/``decompress`` calls in a bounded log
(``cmix_tpu_torch.utils.profiling.CALLS``), and the harness copies each
call's ``dict(meter.t)`` into its record (``ctx["enc"][i]["phases"]``).  A
logged Meter whose phases equal a record's is that call's.  The module
is looked up among the loaded ones, as the harness loaded the program: a
reader loads nothing.  A program without the log (one that keeps no spans)
gives no Meters, and its readers read nothing.
"""

import statistics
import sys

PROFILING = "cmix_tpu_torch.utils.profiling"


def window_meters(ctx):
    """The logged Meters of the window's untraced encode calls, in the
    order of ``ctx["enc"]`` ([] where the program logs none)."""
    logged = list(getattr(sys.modules.get(PROFILING), "CALLS", None) or ())
    found = []
    for rec in ctx["enc"]:
        m = next((m for m in logged
                  if getattr(m, "t", None) == rec["phases"]), None)
        if m is not None and m not in found:
            found.append(m)
    return found


def roots(meter):
    """The Meter's call roots (spans without a parent)."""
    return [s for s in meter.spans if s.parent is None]


def replay_samples(meters):
    """Every replay's device ms, over the Meters' calls."""
    return [ms for m in meters for call in m.replay_ms.values()
            for ms in call]


def median(xs):
    """The median of ``xs``, or None where there is none."""
    return statistics.median(xs) if xs else None
