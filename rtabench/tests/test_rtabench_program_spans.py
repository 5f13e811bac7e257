"""The readers of the program's spans (``rtabench/program_spans.py``):
each span counted in the job that holds its start, the warm job's left
out, nothing without the recorder's spans, and reading changes neither
the recorder nor the run."""

import time
import types

import pytest

from basicrta_torch import spans
from rtabench import harness
from rtabench.tracing import Spans

READERS = ("checkpoint_s.residue", "checkpoint_mb.residue",
           "post_s.residue", "gmm_host_reads.residue", "post_idle_s.residue")


class _Trace:
    """A device trace idle over the one gap it is given."""

    def __init__(self, gap):
        self.gap = gap

    def busy(self):
        return 0.0, [self.gap]


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _run():
    """A run of one job holding a checkpoint, a GMM inside post.batch and
    a warm job's spans before it."""
    spans.enable()
    with spans.span("sampler.checkpoint"):      # the warm job's
        spans.add("bytes", 5_000_000)
    job0 = time.time_ns()
    for _ in range(2):
        with spans.span("sampler.checkpoint"):
            spans.add("bytes", 1_500_000)
            time.sleep(0.002)
    with spans.span("post.batch") as post:
        with spans.span("post.gmm"):
            spans.add("host_reads", 3)
            spans.add("host_reads", 4)
        time.sleep(0.003)
    job1 = time.time_ns()
    spans.disable()
    run = types.SimpleNamespace(spans=Spans(), trace=_Trace((post.t0,
                                                            post.t1)))
    run.spans.items.append(("job", 0, job0, job1, None))
    return run, post


def test_readers_take_each_job_and_change_nothing():
    run, post = _run()
    kept = [s.id for s in spans.records()]
    items = list(run.spans.items)
    first = {n: harness.metric_reader(n)(run) for n in READERS}
    assert first == {n: harness.metric_reader(n)(run) for n in READERS}
    assert [s.id for s in spans.records()] == kept
    assert run.spans.items == items
    assert first["checkpoint_mb.residue"] == pytest.approx(3.0)
    assert first["checkpoint_s.residue"] >= 0.004
    assert first["gmm_host_reads.residue"] == 7
    assert first["post_s.residue"] == pytest.approx((post.t1 - post.t0)
                                                    / 1e9)
    assert first["post_idle_s.residue"] == pytest.approx(
        first["post_s.residue"])


def test_no_program_spans_no_reading():
    run, _ = _run()
    spans.drain()
    assert all(harness.metric_reader(n)(run) is None for n in READERS)
    run, _ = _run()
    run.trace = None
    assert harness.metric_reader("post_idle_s.residue")(run) is None
