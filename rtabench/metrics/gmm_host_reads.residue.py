"""Host reads of the card's flags a job in the GMM (counter ``host_reads``
on the span ``post.gmm``: one each Lloyd step and each EM iteration)."""

from rtabench.program_spans import counter, job_mean, program_spans


def read(run):
    return job_mean(program_spans(run), "post.gmm", counter("host_reads"))
