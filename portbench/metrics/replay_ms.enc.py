"""Median device ms of a graph replay (one byte step) while encoding: every
replay of the window's untraced encode calls, each timed by the program's
own CUDA events on the stream, one before a segment's first replay and
one after each replay (``engine._Segments``).  Replays follow each other
on the device with no host wait between them, so each sample is that
replay's own device time, the gaps inside its graph included.  512
samples an encode call (64 lanes x 512 B: one segment of 512 steps), about
2,300 over a 51 s window.  Nothing is read on the eager step or from a
program that times no replay."""

from portbench.metrics._program_log import (median, replay_samples,
                                            window_meters)


def read(ctx):
    return median(replay_samples(window_meters(ctx)))
