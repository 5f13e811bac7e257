"""Seconds from the process's start to the end of the warm-up: imports,
inputs, builds and the warm job."""


def read(run):
    return run.setup_s
