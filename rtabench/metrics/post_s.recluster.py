"""``post_s.residue``'s reading, in the cells that report
``recluster_job_s``."""

from rtabench.harness import metric_reader


def read(run):
    return metric_reader("post_s.residue")(run)
