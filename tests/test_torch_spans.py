"""The span recorder (``basicrta_torch.spans``) on the CPU: nesting and
parent ids, counters on the innermost open span, nothing recorded while
off, the ``time.time_ns()`` clock, every span of the tau job (``gibbs``
then ``cluster``) with its counters, results bitwise equal with the
recorder on and off, spans under a profiler, the bound on undrained
records, and ``gibbs --profile``'s trace naming the program's stages."""

import contextlib
import io
import json
import os
import time

import numpy as np
import pytest

from basicrta_torch import cli, spans
from basicrta_torch.config import GibbsConfig
from basicrta_torch.contacts.records import ContactEvents, ContactMeta
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.protein.driver import ParallelGibbs, ProcessProtein

# every span the tau job records, by layer
JOB_SPANS = ("sampler.layout", "sampler.segment", "sampler.wait",
             "sampler.checkpoint", "post.batch", "post.prep", "post.gmm",
             "post.votes", "post.finish", "post.tau", "post.save")
CFG = GibbsConfig(ncomp=4, niter=200, g=10, burnin=60, n_chains=2,
                  gmm_n_init=3, seed=7)


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _events():
    sizes = {10: 1500, 20: 300}   # two buckets of the pow2 ladder
    rng = np.random.default_rng(3)
    resids = np.concatenate([np.full(n, r, np.int32)
                             for r, n in sizes.items()])
    dur = np.concatenate([discretize_times(simulate_hyperexp(
        n, [0.85, 0.15], [2.0, 0.1], rng), 0.1) for n in sizes.values()])
    return ContactEvents(resids, np.zeros_like(resids), np.zeros_like(dur),
                         dur, ContactMeta(cutoff=7.0))


def _tau_job(root):
    """``gibbs`` then ``cluster`` in process: the sampled chains and the
    tau table."""
    gibbs = ParallelGibbs(_events(), CFG, root).run(engine="torch",
                                                    device="cpu")
    pp = ProcessProtein(cfg=CFG, cutoff=7.0, root=root, device="cpu")
    pp.get_taus()
    table = np.load(pp.write_data())
    return gibbs, table


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The tau job twice, the recorder off then on: (off, on, its spans)."""
    spans.disable()
    spans.drain()
    off = _tau_job(str(tmp_path_factory.mktemp("off")))
    spans.enable()
    try:
        on = _tau_job(str(tmp_path_factory.mktemp("on")))
    finally:
        spans.disable()
    return off, on, spans.drain()


def test_spans_nest_with_parent_ids():
    spans.enable()
    with spans.span("outer", a=1) as outer:
        with spans.span("inner") as inner:
            pass
        with spans.span("second"):
            with spans.span("deep"):
                pass
    drained = spans.drain()
    got = {s.name: s for s in drained}
    assert outer.parent == 0 and got["outer"] is outer
    assert inner.parent == outer.id and got["second"].parent == outer.id
    assert got["deep"].parent == got["second"].id
    assert len({s.id for s in got.values()}) == 4
    assert outer.attrs == {"a": 1}
    # records come in the order spans end
    assert [s.name for s in drained] == ["inner", "deep", "second", "outer"]
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


def test_counters_land_on_the_innermost_open_span():
    spans.enable()
    with spans.span("outer") as outer:
        spans.add("n")
        with spans.span("inner") as inner:
            spans.add("n", 3)
            spans.add("bytes", 10)
        spans.add("n", 2)
    assert outer.attrs == {"n": 3}
    assert inner.attrs == {"n": 3, "bytes": 10}
    spans.drain()
    spans.add("n")          # no span open: nothing to count on


def test_off_records_nothing_and_drain_empties():
    assert not spans.recording()
    first = spans.span("a")
    assert first is spans.span("b", k=1)   # one shared no-op context
    with first as got:
        spans.add("n")
        assert got is None
    assert spans.drain() == []
    spans.enable()
    with spans.span("a"):
        pass
    spans.disable()
    with spans.span("b"):
        pass
    assert [s.name for s in spans.drain()] == ["a"]
    assert spans.drain() == []


def test_the_clock_is_time_ns():
    spans.enable()
    before = time.time_ns()
    with spans.span("a") as a:
        time.sleep(0.002)
    after = time.time_ns()
    assert before <= a.t0 < a.t1 <= after
    assert a.t1 - a.t0 >= 2_000_000


def test_the_tau_job_records_every_span(jobs):
    got = jobs[2]
    names = {s.name for s in got}
    assert names == set(JOB_SPANS), names ^ set(JOB_SPANS)
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    # 200 sweeps in segments of 100 blocks of 10: 1 segment a bucket
    assert len(by["sampler.layout"]) == 1
    assert len(by["sampler.segment"]) == len(by["sampler.checkpoint"]) == 2
    assert all(s.attrs["bytes"] > 0 for s in by["sampler.checkpoint"])
    (gmm,) = by["post.gmm"]
    # at least one Lloyd step and one EM iteration, each read on the host
    assert gmm.attrs["host_reads"] >= 2
    assert len(by["post.save"]) == len(by["post.tau"]) == 2
    # the post-processing's stages follow one another inside post.batch
    (batch,) = by["post.batch"]
    post = sorted((s for s in got if s.name.startswith("post.")
                   and s is not batch), key=lambda s: s.t0)
    assert post[0].name == "post.prep" and post[1].name == "post.gmm"
    assert all(s.parent == batch.id for s in post)
    assert batch.t0 <= post[0].t0 and post[-1].t1 <= batch.t1
    assert all(a.t1 <= b.t0 for a, b in zip(post, post[1:]))
    # the sampler's spans lie in the time before the post-processing
    assert max(s.t1 for s in got if s.name.startswith("sampler.")) \
        <= batch.t0


def test_results_are_bitwise_equal_with_the_recorder_on(jobs):
    (off_g, off_t), (on_g, on_t), got = jobs
    assert got
    np.testing.assert_array_equal(off_t, on_t)
    assert set(off_g) == set(on_g)
    for lab in off_g:
        np.testing.assert_array_equal(off_g[lab].mcweights,
                                      on_g[lab].mcweights)
        np.testing.assert_array_equal(off_g[lab].mcrates, on_g[lab].mcrates)
        np.testing.assert_array_equal(off_g[lab].processed.labels,
                                      on_g[lab].processed.labels)
        assert off_g[lab].tau == on_g[lab].tau


def test_a_profiler_records_spans_and_names_them():
    """A profiler alone records spans and adds nothing to its own trace;
    with the recorder enabled as well, each span is a range in it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.recording()
        with spans.span("probe.outer"):
            with spans.span("probe.inner"):
                spans.add("n")
    assert not spans.recording()
    got = {s.name: s for s in spans.drain()}
    assert got["probe.inner"].attrs == {"n": 1}
    assert got["probe.inner"].parent == got["probe.outer"].id
    names = {e.key for e in prof.key_averages()}
    assert not {"probe.outer", "probe.inner"} & names
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("probe.outer"):
            with spans.span("probe.inner"):
                pass
    names = {e.key for e in prof.key_averages()}
    assert {"probe.outer", "probe.inner"} <= names
    assert [s.name for s in spans.drain()] == ["probe.inner", "probe.outer"]


def test_records_keep_the_newest_undrained_spans():
    spans.enable()
    for i in range(spans.MAX_RECORDS + 5):
        with spans.span("s", i=i):
            pass
    kept = spans.records()
    assert len(kept) == spans.MAX_RECORDS
    assert kept[0].attrs["i"] == 5 and kept[-1].attrs["i"] == i
    assert len(spans.records()) == spans.MAX_RECORDS   # records keeps them
    assert len(spans.drain()) == spans.MAX_RECORDS
    assert spans.records() == []


def test_gibbs_profile_trace_names_the_stages(tmp_path):
    d = str(tmp_path)
    _events().save(os.path.join(d, "contacts_7.0.npz"))
    trace = os.path.join(d, "trace")
    old = os.getcwd()
    os.chdir(d)
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            cli.main(["gibbs", "--contacts", "contacts_7.0.npz", "--niter",
                      "40", "--g", "10", "--ncomp", "3", "--nchains", "1",
                      "--engine", "torch", "--resid", "20", "--profile",
                      trace])
    finally:
        os.chdir(old)
    with open(os.path.join(trace, "gibbs_trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sampler.segment", "post.gmm", "post.batch"} <= names
    assert not spans.recording() and spans.records() == []
