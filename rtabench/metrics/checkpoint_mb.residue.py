"""Megabytes a job of checkpoint files written (counter ``bytes`` of span
``sampler.checkpoint``, each file's size on disk)."""

from rtabench.program_spans import counter, job_mean, program_spans


def read(run):
    return job_mean(program_spans(run), "sampler.checkpoint",
                    counter("bytes", 1e6))
