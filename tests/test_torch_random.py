"""The port's samplers (``basicrta_torch.ops.random``) through the JAX
package's battery (``tests/test_random.py``), plus the bounded samplers,
and one two-sample KS test per sampler between the JAX package's draws and
the port's at the same parameters (p > 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from basicrta_torch.ops import random as tr
from basicrta_tpu.ops import random as jr

TINY = np.finfo(np.float32).tiny


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _full(shape, value):
    return torch.full(shape, float(value))


def _chi2_ok(m, n, p):
    """Chi-square goodness of fit of integer draws against Binomial(n, p),
    at the battery's 1e-4 level."""
    size = len(m)
    counts = np.bincount(m.astype(int), minlength=n + 1)
    pmf = stats.binom.pmf(np.arange(n + 1), n, p)
    keep = pmf * size > 5
    chi2 = np.sum((counts[keep] - size * pmf[keep]) ** 2
                  / (size * pmf[keep]))
    return chi2 < stats.chi2.ppf(0.9999, max(keep.sum() - 1, 1))


@pytest.mark.parametrize("n,p", [(5, 0.3), (40, 0.02), (100, 0.5),
                                 (1000, 0.013), (5000, 0.4), (200000, 0.25),
                                 (446605, 0.8), (17, 0.97)])
def test_binomial_moments(n, p):
    size = 40000
    m = tr.binomial(_full((size,), n), _full((size,), p), _gen(n)).numpy()
    mean, var = n * p, n * p * (1 - p)
    assert m.mean() == pytest.approx(mean, abs=5 * np.sqrt(var / size))
    assert m.var() == pytest.approx(var, rel=0.1)
    assert m.min() >= 0 and m.max() <= n
    assert np.array_equal(m, np.round(m))


# (300, 0.2) is the BTRS region (n p > 10), the others inversion
@pytest.mark.parametrize("n,p", [(8, 0.35), (30, 0.1), (60, 0.5),
                                 (300, 0.2)])
def test_binomial_exact_pmf(n, p):
    size = 60000
    m = tr.binomial(_full((size,), n), _full((size,), p), _gen(7)).numpy()
    assert _chi2_ok(m, n, p)


def test_binomial_edges():
    n = torch.tensor([0.0, 10.0, 10.0, 7.0, -3.0, 12.0])
    p = torch.tensor([0.5, 0.0, 1.0, 0.5, 0.5, 1.5])
    m = tr.binomial(n, p, _gen(0)).numpy()
    assert m[0] == 0 and m[1] == 0 and m[2] == 10
    assert 0 <= m[3] <= 7
    assert m[4] == 0            # a negative count draws nothing
    assert m[5] == 12           # p clipped to 1


@pytest.mark.parametrize("a", [0.5, 1.0, 2.5, 40.0, 5000.0])
def test_gamma_ks(a):
    g = tr.gamma(_full((40000,), a), _gen(int(a * 10))).numpy()
    assert np.all(g > 0)
    assert stats.kstest(g, "gamma", args=(a,)).pvalue > 1e-4


@pytest.mark.parametrize("a", [1.0 / 15.0, 1e-3])
def test_gamma_tiny_shapes(a):
    """The prior's shapes underflow f32 for a share of draws: moments
    hold, every draw is at least the smallest normal f32 and its log is
    finite."""
    size = 60000
    g = tr.gamma(_full((size,), a), _gen(2)).numpy()
    assert g.min() >= TINY
    assert np.isfinite(np.log(g)).all()
    g64 = g.astype(np.float64)
    assert g64.mean() == pytest.approx(a, abs=5 * np.sqrt(a / size))
    if a > 0.01:
        assert g64.var() == pytest.approx(a, rel=0.15)


def test_dirichlet_moments():
    alpha = np.full(15, 1 / 15, np.float32) + np.arange(15, dtype=np.float32)
    size = 20000
    d = tr.dirichlet(torch.tensor(alpha).repeat(size, 1), _gen(0)).numpy()
    assert np.allclose(d.sum(axis=1), 1.0, atol=1e-5)
    a0 = alpha.sum()
    var = alpha * (a0 - alpha) / (a0 ** 2 * (a0 + 1))
    assert np.allclose(d.mean(axis=0), alpha / a0,
                       atol=5 * np.sqrt(var / size))


def test_dirichlet_tiny_prior_stays_finite():
    d = tr.dirichlet(_full((5000, 15), 1 / 15), _gen(3)).numpy()
    assert d.min() > 0 and np.isfinite(np.log(d)).all()
    assert np.allclose(d.sum(axis=1), 1.0, atol=1e-5)


def test_multinomial_exact_totals():
    n = torch.tensor([0.0, 7.0, 446605.0])
    probs = torch.tensor(np.random.default_rng(0).dirichlet(
        np.ones(15)).astype(np.float32)).repeat(3, 1)
    m = tr.multinomial(n, probs, _gen(0)).numpy()
    np.testing.assert_array_equal(m.sum(axis=1), n.numpy())
    assert np.all(m >= 0)


@pytest.mark.parametrize("sampler", ["chain", "small"])
def test_multinomial_mean_cov(sampler):
    size, n = 30000, 13
    p = np.array([0.5, 0.3, 0.15, 0.05], dtype=np.float32)
    probs = torch.tensor(p).repeat(size, 1)
    if sampler == "chain":
        m = tr.multinomial(_full((size,), n), probs, _gen(1)).numpy()
    else:
        m = tr.multinomial_small(_full((size,), n), probs, 16,
                                 _gen(1)).numpy()
    np.testing.assert_array_equal(m.sum(axis=1), n)
    assert np.allclose(m.mean(axis=0), n * p,
                       atol=5 * np.sqrt(n * p * (1 - p) / size))
    c = np.cov(m.T)
    assert c[0, 1] == pytest.approx(-n * p[0] * p[1], rel=0.15)
    assert np.allclose(np.diag(c), n * p * (1 - p), rtol=0.1)


@pytest.mark.parametrize("n", [0, 1, 5, 16])
def test_binomial_small_exact_pmf(n):
    size = 60000
    m = tr.binomial_small(_full((size,), n), _full((size,), 0.3), 16,
                          _gen(n)).numpy()
    assert m.min() >= 0 and m.max() <= n
    if n:
        assert _chi2_ok(m, n, 0.3)


def test_binomial_small_edges():
    n = torch.tensor([0.0, 16.0, 16.0, 9.0])
    p = torch.tensor([0.5, 0.0, 1.0, 1.0])
    np.testing.assert_array_equal(
        tr.binomial_small(n, p, 16, _gen(0)).numpy(), [0, 0, 16, 9])


def test_multinomial_small_and_single_totals():
    rng = np.random.default_rng(5)
    probs = torch.tensor(rng.dirichlet(np.ones(6), 500).astype(np.float32))
    n = torch.tensor(rng.integers(0, 17, 500).astype(np.float32))
    m = tr.multinomial_small(n, probs, 16, _gen(4))
    torch.testing.assert_close(m.sum(-1), n, rtol=0, atol=0)
    one = torch.tensor(rng.integers(0, 2, 500).astype(np.float32))
    m1 = tr.multinomial_single(one, probs, _gen(4))
    torch.testing.assert_close(m1.sum(-1), one, rtol=0, atol=0)
    assert ((m1 == 0) | (m1 == 1)).all()


def test_multinomial_single_probabilities():
    size = 40000
    p = np.array([0.5, 0.3, 0.15, 0.05], dtype=np.float32)
    m = tr.multinomial_single(torch.ones(size), torch.tensor(p).repeat(
        size, 1), _gen(6)).numpy()
    assert np.allclose(m.mean(axis=0), p,
                       atol=5 * np.sqrt(p * (1 - p) / size))


_P4 = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
# sampler name -> (the JAX package's draws, the port's draws), 20,000 each;
# multinomials give the first component's count
_KS_CASES = {
    "binomial_inversion": (
        lambda k, s: jr.binomial(k, jnp.full(s, 30.0), jnp.full(s, 0.1)),
        lambda g, s: tr.binomial(_full(s, 30), _full(s, 0.1), g)),
    "binomial_btrs": (
        lambda k, s: jr.binomial(k, jnp.full(s, 5000.0), jnp.full(s, 0.3)),
        lambda g, s: tr.binomial(_full(s, 5000), _full(s, 0.3), g)),
    "gamma": (lambda k, s: jr.gamma(k, jnp.full(s, 2.5)),
              lambda g, s: tr.gamma(_full(s, 2.5), g)),
    "gamma_prior_shape": (lambda k, s: jr.gamma(k, jnp.full(s, 1 / 15)),
                          lambda g, s: tr.gamma(_full(s, 1 / 15), g)),
    "dirichlet": (
        lambda k, s: jr.dirichlet(k, jnp.tile(jnp.asarray(_P4 * 8),
                                              s + (1,)))[:, 0],
        lambda g, s: tr.dirichlet(torch.tensor(_P4 * 8).repeat(s[0], 1),
                                  g)[:, 0]),
    "binomial_small": (
        lambda k, s: jr.binomial_small(k, jnp.full(s, 11.0),
                                       jnp.full(s, 0.35), 16),
        lambda g, s: tr.binomial_small(_full(s, 11), _full(s, 0.35), 16, g)),
    "multinomial": (
        lambda k, s: jr.multinomial(
            k, jnp.full(s, 300.0), jnp.tile(jnp.asarray(_P4), s + (1,)))[:, 0],
        lambda g, s: tr.multinomial(_full(s, 300), torch.tensor(_P4).repeat(
            s[0], 1), g)[:, 0]),
    "multinomial_small": (
        lambda k, s: jr.multinomial_small(
            k, jnp.full(s, 12.0), jnp.tile(jnp.asarray(_P4), s + (1,)),
            16)[:, 0],
        lambda g, s: tr.multinomial_small(_full(s, 12), torch.tensor(
            _P4).repeat(s[0], 1), 16, g)[:, 0]),
    "multinomial_single": (
        lambda k, s: jr.multinomial_single(
            k, jnp.ones(s), jnp.tile(jnp.asarray(_P4), s + (1,)))[:, 1],
        lambda g, s: tr.multinomial_single(torch.ones(s), torch.tensor(
            _P4).repeat(s[0], 1), g)[:, 1]),
}


@pytest.mark.parametrize("sampler", sorted(_KS_CASES))
def test_two_sample_ks_against_jax(sampler):
    jfn, tfn = _KS_CASES[sampler]
    shape = (20000,)
    a = np.asarray(jfn(jax.random.key(3), shape), np.float64)
    b = tfn(_gen(3), shape).numpy().astype(np.float64)
    assert a.shape == b.shape == shape
    assert stats.ks_2samp(a, b).pvalue > 1e-4
