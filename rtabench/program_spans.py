"""The spans recorded inside the program (``basicrta_torch.spans``), by
job, and what the per-layer metrics read from them: seconds, counters and
the card's idle seconds inside a span.

The program records its spans while ``torch.profiler`` is recording, so
a traced run on the card has them for its window. A span belongs to the
job whose ``job`` span (the benchmark's own) holds its start. A checkout
of the program without the recorder, and a run with no device trace, have
no program spans: every reader then returns None. Reading changes
nothing: neither the program's recorder nor the run.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def program_spans(run) -> list:
    """The program's spans that started in a job of the window, as (name,
    job, t0, t1, attrs)."""
    try:
        from basicrta_torch import spans
    except ImportError:
        return []
    jobs = [(t0, t1, j) for n, j, t0, t1, _ in run.spans.items
            if n == "job"]
    out = []
    for s in spans.records():
        j = next((j for t0, t1, j in jobs if t0 <= s.t0 <= t1), -1)
        if j >= 0:
            out.append((s.name, j, s.t0, s.t1, s.attrs))
    return out


def job_mean(items, name: str, value: Callable):
    """Mean a job of the sum of ``value(t0, t1, attrs)`` over the job's
    ``name`` spans among ``items`` (name, job, t0, t1, attrs); None where
    no job of the window has the span."""
    per: dict = {}
    for n, j, t0, t1, attrs in items:
        if n == name and j >= 0:
            per[j] = per.get(j, 0.0) + value(t0, t1, attrs)
    return float(np.mean(list(per.values()))) if per else None


def seconds(t0, t1, attrs) -> float:
    return (t1 - t0) / 1e9


def counter(key: str, scale: float = 1.0) -> Callable:
    """``value`` that reads the span's counter ``key``."""
    return lambda t0, t1, attrs: attrs.get(key, 0) / scale


def idle_inside(run, name: str):
    """Mean card-idle seconds a job inside the program's ``name`` spans:
    the device trace's gaps intersected with each span; None without a
    trace."""
    if run.trace is None:
        return None
    _, gaps = run.trace.busy()
    gaps = np.asarray(gaps, np.int64).reshape(-1, 2)

    def idle(t0, t1, attrs):
        inside = np.minimum(gaps[:, 1], t1) - np.maximum(gaps[:, 0], t0)
        return float(np.clip(inside, 0, None).sum()) / 1e9

    return job_mean(program_spans(run), name, idle)
