"""``basicrta_torch.ops.surv`` and ``basicrta_torch.ops.diagnostics``
against the JAX package's, on the cases of ``tests/test_surv.py`` and
``tests/test_diagnostics.py`` (plus ``chain_report`` of
``tests/test_aux.py::TestDiagnostics``).

Both are numpy code, so every output is equal bit for bit on the same
inputs (made from seeded numpy generators), and every case also keeps
the JAX test's own assertions on the port's output. The one sampler case,
``TestConvergenceReport::test_gibbs_method``, runs the port's ``Gibbs`` on
``engine="torch"`` at 600 sweeps (the JAX test's 2,000 take minutes on
the plain CPU sweep) and holds ``Gibbs.diagnostics`` to the JAX
package's report on the same chains."""

import numpy as np
import pytest

from basicrta_tpu.config import GibbsConfig as JGibbsConfig
from basicrta_tpu.ops import diagnostics as jd
from basicrta_tpu.ops import surv as js
from basicrta_tpu.sampler.gibbs import Gibbs as JGibbs

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops import diagnostics as td
from basicrta_torch.ops import surv as ts
from basicrta_torch.sampler.gibbs import Gibbs


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The plain sweep is many small eager steps: one intra-op thread."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(a, b)
    assert np.asarray(a).dtype == np.asarray(b).dtype
    assert type(a) is type(b)


# ------------------------------- ops/surv ---------------------------------- #

SURV_CASES = {
    "infer_timestep": [(np.array([0.3, 0.1, 0.1, 0.5, 0.2]),),
                       (np.full(5, 0.4),), (np.array([0.3, 0.6, 0.7]),)],
    "survival_bins": [(np.array([0.1, 0.5]), 0.1),
                      (np.array([0.2, 3.7, 1.1]), 0.05)],
    "survival_function": [(np.array([0.1] * 5 + [0.2] * 3 + [0.5] * 2), 0.1),
                          (np.array([1.0, 2.0, 2.0, 7.0]), 1.0)],
    "empirical_ci": [(np.arange(1, 1001, dtype=float),),
                     (np.array([3.0, 5.0]),),
                     (np.linspace(0.5, 9.0, 37), 90.0)],
    "ci_bars": [(np.array([[1.0, 2.0, 4.0], [0.5, 1.0, 1.5]]),)],
    "decimals_of": [(t,) for t in (0.1, 0.25, 1.0, 2.0, 10.0, 1e-5, 0.002)],
    "start_stop_frames": [
        (np.array([0.0, 5.0, 123.0]), np.array([3.0, 1.0, 7.0]), 1.0),
        (np.array([0.5, 1.0]), np.array([0.3, 0.1]), 0.1),
        (np.array([0.25, 1.75, 3.0]), np.array([0.5, 0.25, 1.0]), 0.25)],
    "discretize_times": [(np.array([0.01, 0.149, 0.15001, 1.0]), 0.1),
                         (np.array([0.003, 2.2449, 7.0]), 0.02)],
}


@pytest.mark.parametrize("fn,case", [(f, i) for f in SURV_CASES
                                     for i in range(len(SURV_CASES[f]))])
def test_surv_helpers_equal(fn, case):
    args = SURV_CASES[fn][case]
    _same(getattr(ts, fn)(*args), getattr(js, fn)(*args))


def test_surv_assertions_hold_on_the_port():
    """The JAX file's fixed-value assertions, on the port."""
    assert ts.infer_timestep(np.array([0.3, 0.1, 0.1, 0.5, 0.2])) == \
        pytest.approx(0.1)
    assert ts.infer_timestep(np.array([0.3, 0.6, 0.7])) == pytest.approx(0.1)
    bins = ts.survival_bins(np.array([0.1, 0.5]), 0.1)
    assert bins[0] == pytest.approx(0.1) and bins[-1] >= 0.6
    t, s = ts.survival_function(np.array([0.1] * 5 + [0.2] * 3 + [0.5] * 2),
                                0.1)
    assert t[0] == 0.0 and s[0] == 1.0 and np.all(np.diff(s) <= 0)
    assert s[1] == pytest.approx(0.5) and s[-1] == pytest.approx(0.0)
    assert ts.empirical_ci(np.arange(1, 1001, dtype=float)) == \
        pytest.approx((25.0, 975.0))
    assert tuple(ts.empirical_ci(np.array([3.0, 5.0]))) == (3.0, 5.0)
    assert np.allclose(ts.ci_bars(np.array([[1.0, 2.0, 4.0],
                                            [0.5, 1.0, 1.5]])),
                       [[1.0, 0.5], [2.0, 0.5]])
    assert [ts.decimals_of(x) for x in (0.1, 0.25, 1.0, 2.0, 10.0, 1e-5)] \
        == [1, 2, 0, 0, -1, 5]
    first, last = ts.start_stop_frames(np.array([0.0, 5.0, 123.0]),
                                       np.array([3.0, 1.0, 7.0]), 1.0)
    assert first.tolist() == [0, 5, 123] and last.tolist() == [2, 5, 129]
    x = ts.discretize_times(np.array([0.01, 0.149, 0.15001, 1.0]), 0.1)
    assert np.allclose(x, [0.1, 0.1, 0.2, 1.0])


@pytest.mark.parametrize("n,w,r", [
    (1e5, [0.9, 0.09, 0.01], [5, 0.05, 0.001]),
    (2e5, [0.7, 0.3], [2.0, 0.1])])
def test_simulate_hyperexp_equal(n, w, r):
    """The same draws from two generators of one seed; the JAX file's
    uniqueness, order and mean checks on the port's."""
    x = ts.simulate_hyperexp(n, w, r, np.random.default_rng(11))
    _same(x, js.simulate_hyperexp(n, w, r, np.random.default_rng(11)))
    assert len(np.unique(x)) == len(x) and np.all(np.diff(x) >= 0)
    assert x.mean() == pytest.approx(float(np.sum(np.asarray(w)
                                                  / np.asarray(r))),
                                     rel=0.05)


def test_unique_rate_count_equal():
    rng = np.random.default_rng(0)
    mc = np.stack([rng.normal(5.0, 0.01, 1000),
                   rng.normal(0.1, 0.001, 1000),
                   rng.normal(0.1, 0.001, 1000)], axis=1)
    assert ts.unique_rate_count(3, mc) == js.unique_rate_count(3, mc) == 1
    mc2 = np.stack([rng.normal(m, 0.01, 500) for m in (4.0, 1.0, 0.05)], 1)
    assert ts.unique_rate_count(3, mc2) == js.unique_rate_count(3, mc2)


# ---------------------------- ops/diagnostics ------------------------------ #

def _ar1(rng, rho=0.9, C=4, S=4000):
    x = np.empty((C, S))
    x[:, 0] = rng.normal(size=C)
    eps = rng.normal(size=(C, S)) * np.sqrt(1 - rho ** 2)
    for t in range(1, S):
        x[:, t] = rho * x[:, t - 1] + eps[:, t]
    return x


def _samples(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "mixed":
        return rng.normal(0.0, 1.0, (4, 500, 3))
    if name == "shifted":
        x = rng.normal(0.0, 1.0, (4, 500))
        x[0] += 5.0
        return x
    if name == "drift":
        return (np.linspace(0.0, 4.0, 600) + rng.normal(0.0, 0.1, 600))[None]
    if name == "constant":
        return np.ones((2, 100, 2))
    if name == "iid":
        return rng.normal(size=(4, 500))
    if name == "ar1":
        return _ar1(rng)
    if name == "vectorized":
        return rng.normal(size=(2, 300, 4, 5))
    raise KeyError(name)


@pytest.mark.parametrize("fn", ["split_rhat", "effective_sample_size"])
@pytest.mark.parametrize("name", ["mixed", "shifted", "drift", "constant",
                                  "iid", "ar1", "vectorized"])
def test_diagnostics_equal(fn, name):
    x = _samples(name)
    a, b = getattr(td, fn)(x), getattr(jd, fn)(x)
    np.testing.assert_array_equal(a, b)
    assert np.shape(a) == np.shape(b)


def test_diagnostics_assertions_hold_on_the_port():
    assert td.split_rhat(_samples("mixed")).shape == (3,)
    assert np.all(td.split_rhat(_samples("mixed")) < 1.02)
    assert td.split_rhat(_samples("shifted")) > 1.5
    assert td.split_rhat(_samples("drift")) > 1.5
    np.testing.assert_allclose(td.split_rhat(_samples("constant")), 1.0)
    assert 1000 < td.effective_sample_size(_samples("iid")) <= 2000
    expect = 4 * 4000 * 0.1 / 1.9
    assert 0.5 * expect < td.effective_sample_size(_samples("ar1")) \
        < 2.0 * expect
    assert td.effective_sample_size(_samples("vectorized")).shape == (4, 5)
    x = np.random.default_rng(1).normal(size=(2, 3))
    for mod in (td, jd):
        with pytest.raises(ValueError):
            mod.split_rhat(x)


def _report_inputs(seed=4):
    rng = np.random.default_rng(seed)
    C, S, K = 3, 400, 6
    W = np.abs(rng.normal(0.2, 0.01, (C, S, K)))
    W[..., 3:] = 1e-9            # dead components
    R = np.abs(rng.normal(1.0, 0.05, (C, S, K)))
    return W, R


@pytest.mark.parametrize("wcutoff", [1e-3, None])
def test_convergence_report_equal(wcutoff):
    W, R = _report_inputs()
    rep = td.convergence_report(W, R, burnin_samples=50, wcutoff=wcutoff)
    _same(rep, jd.convergence_report(W, R, burnin_samples=50,
                                     wcutoff=wcutoff))
    if wcutoff is not None:
        assert rep["rhat_weights"].shape == (3,)   # only live components
        assert rep["max_rhat"] < 1.05 and rep["min_ess"] > 100


def test_chain_report_equal():
    rng = np.random.default_rng(8)
    W = rng.dirichlet(np.ones(4), (3, 200)).reshape(3, 200, 4)
    R = rng.gamma(2.0, size=(3, 200, 4))
    rep = td.chain_report(W, R, burnin_samples=20)
    _same(rep, jd.chain_report(W, R, burnin_samples=20))
    assert rep["rhat_weights"].shape == (4,)
    assert np.all(rep["rhat_rates"] < 1.1)


def test_gibbs_diagnostics_equal_jax_report():
    """``Gibbs.diagnostics`` of the port's two torch-engine chains: equal
    to the JAX package's ``Gibbs.diagnostics`` on the same chains, with the
    JAX test's keys and live filter; the dominant component mixes."""
    x = ts.discretize_times(ts.simulate_hyperexp(
        2000, [0.8, 0.2], [2.0, 0.1], np.random.default_rng(5)), 0.1)
    kw = dict(ncomp=4, niter=600, g=10, burnin=100, n_chains=2, seed=5)
    g = Gibbs(x, residue="T42", cutoff=7.0, cfg=GibbsConfig(**kw))
    g.run(engine="torch", save=False)
    rep = g.diagnostics()
    jg = JGibbs(x, residue="T42", cutoff=7.0, cfg=JGibbsConfig(**kw))
    jg.mcweights, jg.mcrates = g.mcweights, g.mcrates
    _same(rep, jg.diagnostics())
    assert np.isfinite(rep["max_rhat"]) and np.isfinite(rep["min_ess"])
    b = g.cfg.burnin_samples
    mean_w = g.mcweights[:, b:].mean(axis=(0, 1))
    live = mean_w > g.cfg.wcutoff(len(g.times))
    assert rep["rhat_weights"].shape == (int(live.sum()),)
    dom = int(np.where(live)[0].tolist().index(int(mean_w.argmax())))
    assert rep["rhat_weights"][dom] < 1.2
    assert rep["ess_weights"][dom] > 30
