"""Seconds a job in the outside span ``reload``: each ``Gibbs.load`` that
``reprocess`` makes, the file read and the residue's rebuild."""

from rtabench.tracing import span_mean


def read(run):
    return span_mean(run, "reload")
