"""Spans from outside the program, the device trace, and what the
per-layer metrics read from them.

A span is a host-clock interval around one call into a layer of
``basicrta_torch``, made by wrapping the call at its module boundary:
(name, job index, start ns, end ns, payload). Starts and ends are
``time.time_ns()``, the clock the profiler stamps its events with, so an
idle gap on the device can be laid against what the host was doing.

The device trace is ``torch.profiler`` with device activities only: every
kernel, copy and set on the card, reduced to (name, start ns, duration ns).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional

import numpy as np


class Spans:
    """Host spans of one run; ``job`` is the index of the job in flight."""

    def __init__(self):
        self.items: List[tuple] = []
        self.job = -1
        self._patched: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, self.job, t0, time.time_ns(), None))

    def wrap(self, module, attr: str, name: str,
             payload: Optional[Callable] = None) -> None:
        """Replace ``module.attr`` by a wrapper that records a span around
        each call (``payload(result)`` kept beside it); :meth:`restore`
        puts the original back."""
        fn = getattr(module, attr)

        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            out = fn(*args, **kwargs)
            self.items.append((name, self.job, t0, time.time_ns(),
                               None if payload is None else payload(out)))
            return out

        setattr(module, attr, wrapper)
        self._patched.append((module, attr, fn))

    def restore(self) -> None:
        for module, attr, fn in reversed(self._patched):
            setattr(module, attr, fn)
        self._patched = []

    def per_job(self, name: str) -> dict:
        """{job: seconds of every ``name`` span of that job}."""
        out: dict = {}
        for n, j, t0, t1, _ in self.items:
            if n == name and j >= 0:
                out[j] = out.get(j, 0.0) + (t1 - t0) / 1e9
        return out


class DeviceTrace:
    """``torch.profiler`` over a window, device activities only."""

    def __init__(self):
        self.prof = None
        self.events: List[tuple] = []
        self.t0 = self.t1 = 0

    @staticmethod
    def warm():
        """Start and stop the tracer once: its first start is slow."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        self.events = sorted(
            (e.start_ns(), e.duration_ns(), e.name())
            for e in self.prof.profiler.kineto_results.events()
            if e.device_type() == cuda)
        self.prof = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self):
        """(busy seconds, [(gap start ns, gap end ns)]) over the window:
        the union of the device activities and the gaps between them."""
        busy, end, gaps = 0, self.t0, []
        for s, d, _ in self.events:
            e = s + d
            if s > end:
                gaps.append((end, s))
            if e > end:
                busy += e - max(s, end)
                end = e
        if self.t1 > end:
            gaps.append((end, self.t1))
        return busy / 1e9, gaps

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(d for _, d, n in self.events if match(n)) / 1e9

    def top_ops(self, n: int = 10):
        tot: dict = {}
        for _, d, name in self.events:
            key = name if len(name) <= 120 else name[:117] + "..."
            tot[key] = tot.get(key, 0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def idle_gaps(trace: DeviceTrace, spans: Spans, n: int = 10):
    """The ``n`` longest idle gaps of the device, each named by the
    innermost host span that covers its middle."""
    _, gaps = trace.busy()
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        best, width = "other", None
        for name, _, t0, t1, _ in spans.items:
            if t0 <= mid <= t1 and (width is None or t1 - t0 < width):
                best, width = name, t1 - t0
        out.append([best, (b - a) / 1e9])
    return out


# --------------------------- what metrics read ----------------------------- #

def span_mean(run, name: str, minus: Optional[str] = None):
    """Mean seconds a job of the ``name`` spans, less the ``minus`` spans
    inside them; None where the run has none."""
    per = run.spans.per_job(name)
    if not per:
        return None
    sub = run.spans.per_job(minus) if minus else {}
    return float(np.mean([v - sub.get(j, 0.0) for j, v in per.items()]))


def idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy, _ = run.trace.busy()
    return 100.0 * (1.0 - busy / run.trace.window_s)


def roofline_pct(run, kernel: str):
    """Share of the published special-function peak that ``kernel`` (the
    sweep kernel K2 ``segment`` or K3 ``segment_packed``) reached: the
    transcendentals its lanes' own inputs need, over the peak times the
    kernel's device time. None where it did not run."""
    if run.trace is None:
        return None
    work = run.work.get(kernel, 0)
    if kernel == "segment_packed":
        secs = run.trace.kernel_seconds(lambda n: "segment_packed_kernel" in n)
    else:
        secs = run.trace.kernel_seconds(
            lambda n: "segment_kernel" in n and "packed" not in n)
    if work <= 0 or secs <= 0 or not run.peak:
        return None
    return 100.0 * work / (run.peak * secs)
