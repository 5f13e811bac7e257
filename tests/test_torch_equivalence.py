"""The port's posteriors against the independent numpy implementation of
the reference's per-event sweep (``basicrta_torch.scripts.
reference_sampler``, a copy of ``tests/test_equivalence.py``'s), with that
file's rules: the dominant component's posterior means within 8 standard
errors + 1e-4, a two-sample KS on its rate at p > 1e-4, and overlapping
95% intervals of the slowest process's tau."""

import numpy as np
import pytest
import torch
from scipy import stats

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.scripts.reference_sampler import numpy_reference_sampler
from basicrta_torch.scripts.validate import cross_check, dominant, slow_taus
from basicrta_tpu.config import GibbsConfig as JConfig
from test_equivalence import numpy_reference_sampler as jax_reference


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Chains are many small eager steps: with torch's intra-op threads,
    each step waits for threads that the suite's other workers keep busy
    (a 2 s test took minutes). One thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_sampler_copy_is_bitwise_the_original():
    x = discretize_times(simulate_hyperexp(
        500, [0.8, 0.2], [3.0, 0.1], np.random.default_rng(5)), 0.1)
    kw = dict(ncomp=4, niter=60, g=10, burnin=20)
    a = numpy_reference_sampler(x, GibbsConfig(**kw), seed=3)
    b = jax_reference(x, JConfig(**kw), seed=3)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def _check(x, cfg, engine, **kw):
    cc = cross_check(x, cfg, engine, **kw)
    burn, wcut = cfg.burnin_samples, cfg.wcutoff(len(x))
    w_ref, r_ref = dominant(*cc["ref"], burn)
    w_our, r_our = dominant(*cc["ours"], burn)
    for ref, our in ((w_ref, w_our), (r_ref, r_our)):
        se = ref.std() * np.sqrt(2.0 / len(ref))
        assert abs(ref.mean() - our.mean()) < 8 * se + 1e-4, (
            ref.mean(), our.mean())
    assert stats.ks_2samp(r_ref, r_our).pvalue > 1e-4
    lo_r, hi_r = np.percentile(slow_taus(*cc["ref"], burn, wcut), [2.5, 97.5])
    lo, hi = np.percentile(slow_taus(*cc["ours"], burn, wcut), [2.5, 97.5])
    assert lo <= hi_r and lo_r <= hi


def test_collapsed_engine_matches_the_reference_reduced():
    x = discretize_times(simulate_hyperexp(
        3000, [0.8, 0.17, 0.03], [3.0, 0.25, 0.02],
        np.random.default_rng(99)), 0.1)
    cfg = GibbsConfig(ncomp=3, niter=800, g=5, burnin=200, seed=11)
    _check(x, cfg, "collapsed", device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["collapsed", "torch"])
def test_engines_match_the_reference(engine):
    """``tests/test_equivalence.py``'s dataset and sizes."""
    x = discretize_times(simulate_hyperexp(
        12000, [0.8, 0.17, 0.03], [3.0, 0.25, 0.02],
        np.random.default_rng(99)), 0.1)
    cfg = GibbsConfig(ncomp=5, niter=3000, g=10, burnin=1000, seed=11)
    _check(x, cfg, engine, device="cpu")
