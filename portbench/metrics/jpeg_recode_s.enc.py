"""Seconds an encode call spends recoding JPEGs into coefficient planes on
the host (``preprocess/jpeg.jpeg_recode``, inside ``wrt.transform``): the
``jpeg_recode`` spans, summed per call and averaged over the window's
untraced encode calls.  Nothing is read from a program that opens no such
span."""

from portbench.metrics._program_log import window_meters

SPAN = "jpeg_recode"


def read(ctx):
    meters = window_meters(ctx)
    spans = [s for m in meters for s in m.spans if s.name == SPAN]
    calls = sum(1 for m in meters for s in m.spans if s.parent is None)
    if not spans or not calls:
        return None
    return sum(s.seconds for s in spans) / calls
