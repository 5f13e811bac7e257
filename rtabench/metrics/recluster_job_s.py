"""Seconds a whole ``cluster --reprocess`` job: the window over the jobs
it ran (as ``residue_tau_s``, in the cells that report this instead)."""


def read(run):
    return run.window_s / len(run.records)
