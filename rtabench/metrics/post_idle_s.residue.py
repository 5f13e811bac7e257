"""Seconds a job the card is idle inside post-processing: the device
trace's gaps within span ``post.batch``."""

from rtabench.program_spans import idle_inside


def read(run):
    return idle_inside(run, "post.batch")
