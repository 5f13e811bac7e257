"""Checkpoints a job written while the bucket's next segment was in flight
(counter ``behind`` of span ``sampler.checkpoint``). None where the
program's checkpoints carry no such counter."""

from rtabench.program_spans import counter, job_mean, program_spans


def read(run):
    items = [s for s in program_spans(run) if "behind" in s[4]]
    return job_mean(items, "sampler.checkpoint", counter("behind"))
