"""Seconds a whole tau job: the window over the jobs it ran."""


def read(run):
    return run.window_s / len(run.records)
