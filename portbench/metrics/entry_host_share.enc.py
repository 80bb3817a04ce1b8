"""Share of each encode call's seconds spent outside the transcoder
(container, content transform, routing, state set-up), in %: (call seconds
- the call's Meter wall) summed over the window's untraced encode calls,
over their seconds.  Host clocks on both sides."""


def read(ctx):
    calls = ctx["enc"]
    total = sum(c["seconds"] for c in calls)
    if not calls or total <= 0:
        return None
    return 100.0 * sum(c["seconds"] - c["meter_s"] for c in calls) / total
