"""Seconds a job in ``run_residues`` less its layout: the sampling, with
its checkpoints."""

from rtabench.tracing import span_mean


def read(run):
    return span_mean(run, "run_residues", minus="layout")
