"""Byte steps an input byte buys: the payload bytes the content transforms
give (JPEG recoding grows a photo into its coefficient planes) over the
input bytes, from the program's counters (``payload_bytes``, ``in_bytes``;
``utils/profiling.Meter.count``), summed over the window's untraced
encode calls.  Nothing is read from a program that keeps no counters."""

from portbench.metrics._program_log import window_meters


def read(ctx):
    payload = in_bytes = 0
    for m in window_meters(ctx):
        for c in (getattr(m, "counts", None) or {}).values():
            if "payload_bytes" in c and c.get("in_bytes"):
                payload += c["payload_bytes"]
                in_bytes += c["in_bytes"]
    return payload / in_bytes if in_bytes else None
