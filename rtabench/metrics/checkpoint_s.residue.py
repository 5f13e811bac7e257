"""Seconds a job in the sampler's checkpoints (span ``sampler.checkpoint``:
the chain state copied to the host and ``save_checkpoint``)."""

from rtabench.program_spans import job_mean, program_spans, seconds


def read(run):
    return job_mean(program_spans(run), "sampler.checkpoint", seconds)
