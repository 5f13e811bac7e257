"""Seconds a job in post-processing (span ``post.batch``: ``finish_batch``,
the GMM, the votes, tau and the save)."""

from rtabench.program_spans import job_mean, program_spans, seconds


def read(run):
    return job_mean(program_spans(run), "post.batch", seconds)
