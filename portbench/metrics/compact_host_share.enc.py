"""Share of the transcoder's wall in the host's compaction of the segments'
outputs, in %: the Meter's ``host`` phase over its wall, summed over the
window's untraced encode calls."""


def read(ctx):
    wall = sum(c["meter_s"] for c in ctx["enc"])
    if wall <= 0:
        return None
    return 100.0 * sum(c["phases"].get("host", 0.0)
                       for c in ctx["enc"]) / wall
