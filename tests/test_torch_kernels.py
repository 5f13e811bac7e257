"""The port's reference sweeps (``basicrta_torch.sampler.kernels``) against
the JAX package's (``basicrta_tpu.sampler.kernels``): deterministic parts
at f32 rounding, random parts in law, totals exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import kernels as tk
from basicrta_tpu.config import GibbsConfig as JConfig
from basicrta_tpu.sampler import kernels as jk


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Chains are many small eager steps: with torch's intra-op threads,
    each step waits for threads that the suite's other workers keep busy
    (a 2 s test took minutes). One thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _state(rng, K, lead=()):
    w = rng.dirichlet(np.ones(K), lead or None).astype(np.float32)
    r = rng.uniform(0.01, 5.0, lead + (K,)).astype(np.float32)
    return w, r


@pytest.fixture(scope="module")
def data():
    """A residue's (unique values, multiplicities) in multiplicity order,
    with its tiers."""
    from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
    x = discretize_times(simulate_hyperexp(
        6000, [0.8, 0.17, 0.03], [3.0, 0.25, 0.02],
        np.random.default_rng(21)), 0.1)
    v, c = tk.dedup_times(x)
    order, tiers = tk.compute_tiers(c)
    assert tiers[0] > 0 and tiers[1] > tiers[0] and len(v) > tiers[1]
    return x, v[order], c[order], tiers


@pytest.mark.parametrize("K", [3, 5, 15])
def test_init_mixture_params_equal_jax(K):
    a, b = tk.init_mixture_params(K), jk.init_mixture_params(K)
    np.testing.assert_array_equal(a.weights.numpy(), np.asarray(b.weights))
    np.testing.assert_array_equal(a.rates.numpy(), np.asarray(b.rates))


def test_log_responsibilities_and_softmax_equal_jax(data):
    _, v, _, _ = data
    w, r = _state(np.random.default_rng(1), 5)
    got = tk._log_responsibilities(tk.MixtureState(_f32(w), _f32(r)),
                                   _f32(v))
    ref = jk._log_responsibilities(jk.MixtureState(jnp.asarray(w),
                                                   jnp.asarray(r)),
                                   jnp.asarray(v, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(torch.softmax(got, -1).numpy(),
                               np.asarray(jax.nn.softmax(ref, -1)),
                               rtol=1e-6, atol=1e-7)


def test_rao_blackwellized_counts_equal_jax(data):
    _, v, c, _ = data
    W, R = _state(np.random.default_rng(2), 4, (20,))
    cfg = GibbsConfig(ncomp=4)
    got = tk.sample_indicator_counts(_gen(0), _f32(W), _f32(R), _f32(v),
                                     _f32(c), cfg, rao=True)
    ref = jk.sample_indicator_counts(
        jax.random.key(0), jnp.asarray(W), jnp.asarray(R),
        jnp.asarray(v, jnp.float32), jnp.asarray(c, jnp.float32),
        JConfig(ncomp=4), rao=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_multinomial_counts_exact():
    n = _f32([100, 0, 7, 100000])
    p = _f32([[0.5, 0.3, 0.2], [0.1, 0.1, 0.8], [1.0, 0.0, 0.0],
              [0.25, 0.25, 0.5]])
    m = tk.multinomial_counts(n, p, _gen(0)).numpy()
    np.testing.assert_array_equal(m.sum(axis=1), n.numpy())
    assert np.all(m >= 0) and np.all(m[1] == 0) and m[2, 0] == 7
    exp = 100000 * p[3].numpy()
    assert np.all(np.abs(m[3] - exp) < 5 * np.sqrt(exp * (1 - p[3].numpy())))


def test_sweep_and_indicator_totals_exact(data):
    _, v, c, tiers = data
    cfg = GibbsConfig(ncomp=5)
    st = tk.init_mixture_params(5)
    for t in (tiers, None):
        new, m = tk.collapsed_sweep(_gen(1), st, _f32(v), _f32(c), cfg,
                                    return_counts=True, tiers=t)
        np.testing.assert_array_equal(m.sum(-1).numpy(), c)
        assert new.weights.sum().item() == pytest.approx(1.0, rel=1e-5)
        assert (new.rates > 0).all()
    W, R = _state(np.random.default_rng(3), 5, (6,))
    m = tk.sample_indicator_counts(_gen(2), _f32(W), _f32(R), _f32(v),
                                   _f32(c), cfg)
    assert m.shape == (6, len(v), 5)
    np.testing.assert_array_equal(m.sum(-1).numpy(),
                                  np.broadcast_to(c, (6, len(v))))


def _sweep_counts(data, reps, seed):
    """(reps, K) N_k of one tiered sweep from a fixed state, reps chains
    at once, and the state's expected N_k."""
    _, v, c, tiers = data
    w, r = _state(np.random.default_rng(4), 5)
    st = tk.MixtureState(_f32(w).repeat(reps, 1), _f32(r).repeat(reps, 1))
    _, m = tk.collapsed_sweep(_gen(seed), st, _f32(v), _f32(c),
                              GibbsConfig(ncomp=5), return_counts=True,
                              tiers=tiers)
    probs = torch.softmax(tk._log_responsibilities(
        tk.MixtureState(_f32(w), _f32(r)), _f32(v)), -1).double().numpy()
    return m.sum(-2).double().numpy(), (w, r), probs


def test_sweep_counts_mean_matches_responsibilities(data):
    """E[N_k] = sum_v c_v z_vk: the mean over 2,000 sweeps from one state
    within 5 standard errors."""
    _, _, c, _ = data
    reps = 2000
    Ns, _, z = _sweep_counts(data, reps, 5)
    exp = (c[:, None] * z).sum(0)
    se = np.sqrt((c[:, None] * z * (1 - z)).sum(0) / reps)
    assert np.all(np.abs(Ns.mean(0) - exp) < 5 * se + 1e-9)


def test_sweep_counts_match_jax_in_law(data):
    _, v, c, tiers = data
    reps = 2000
    Ns, (w, r), _ = _sweep_counts(data, reps, 6)
    st = jk.MixtureState(jnp.asarray(w), jnp.asarray(r))
    cfg = JConfig(ncomp=5)

    def one(key):
        _, m = jk.collapsed_sweep(key, st, jnp.asarray(v, jnp.float32),
                                  jnp.asarray(c, jnp.float32), cfg,
                                  return_counts=True, tiers=tiers)
        return m.sum(0)

    ref = np.asarray(jax.vmap(one)(jax.random.split(jax.random.key(6),
                                                    reps)), np.float64)
    for k in range(5):
        if ref[:, k].std() > 0:
            assert stats.ks_2samp(ref[:, k], Ns[:, k]).pvalue > 1e-4, k


def test_dense_and_collapsed_agree(synthetic_times):
    """The collapsed chain is the dense chain in law: the dominant
    component's posterior moments over 8 chains agree (rel 0.05) and
    recover the truth (weight rel 0.05, rate rel 0.10), as
    ``tests/test_kernels.py``."""
    x, w_true, r_true = synthetic_times
    cfg = GibbsConfig(ncomp=5, niter=300, g=5, burnin=100)
    v, c = tk.dedup_times(x)
    Wc, Rc = tk.run_chains(_gen(42), _f32(v), _f32(c), cfg, "collapsed",
                           n_chains=8)
    Wd, Rd = tk.run_chains(_gen(42), _f32(x), None, cfg, "dense",
                           n_chains=8)
    b = cfg.burnin_samples

    def top(W, R):
        """Each chain's dominant component, pooled over the chains."""
        W, R = W[:, b:].numpy(), R[:, b:].numpy()
        i = W.mean(axis=1).argmax(axis=1)
        rows = np.arange(len(i))
        return W[rows, :, i].mean(), R[rows, :, i].mean()

    wc, rc = top(Wc, Rc)
    wd, rd = top(Wd, Rd)
    assert wc == pytest.approx(wd, rel=0.05)
    assert rc == pytest.approx(rd, rel=0.05)
    assert wc == pytest.approx(w_true[0], rel=0.05)
    assert rc == pytest.approx(r_true[0], rel=0.10)


def test_dense_sweep_indicator_and_mask(data):
    x = _f32(data[0][:500])
    mask = torch.ones(500)
    mask[400:] = 0
    cfg = GibbsConfig(ncomp=4)
    st = tk.init_mixture_params(4)
    new, s = tk.dense_sweep(_gen(3), st, x, mask, cfg,
                            return_indicator=True)
    assert s.dtype == torch.uint8 and s.shape == (500,)
    assert int(s.max()) < 4
    assert new.weights.sum().item() == pytest.approx(1.0, rel=1e-5)


def test_padding_draws_nothing(data):
    """Zero-count pads draw nothing, exactly; the live columns' counts keep
    their law (the generator is not prefix-stable over shapes, so the
    JAX package's bitwise form of this test does not carry over)."""
    _, v, c, tiers = data
    reps = 1000
    pad = 17
    vp = np.concatenate([v, np.ones(pad)])
    cp = np.concatenate([c, np.zeros(pad)])
    w, r = _state(np.random.default_rng(7), 4)
    st = tk.MixtureState(_f32(w).repeat(reps, 1), _f32(r).repeat(reps, 1))
    cfg = GibbsConfig(ncomp=4)
    _, m1 = tk.collapsed_sweep(_gen(8), st, _f32(v), _f32(c), cfg,
                               return_counts=True, tiers=tiers)
    _, m2 = tk.collapsed_sweep(_gen(9), st, _f32(vp), _f32(cp), cfg,
                               return_counts=True, tiers=tiers)
    assert (m2[:, -pad:] == 0).all()
    np.testing.assert_array_equal(m2.sum(-1).numpy()[:, :-pad],
                                  np.broadcast_to(c, (reps, len(c))))
    a, b = m1.sum(1).numpy(), m2[:, :-pad].sum(1).numpy()
    for k in range(4):
        if a[:, k].std() > 0:
            assert stats.ks_2samp(a[:, k], b[:, k]).pvalue > 1e-4, k


def test_run_chains_shapes_and_distinct_chains(data):
    _, v, c, tiers = data
    cfg = GibbsConfig(ncomp=4, niter=300, g=10, burnin=100)
    W, R = tk.run_chains(_gen(0), _f32(v), _f32(c), cfg, "collapsed",
                         n_chains=3, tiers=tiers)
    assert W.shape == R.shape == (3, cfg.n_samples, 4)
    assert not torch.allclose(W[0], W[1])
    assert torch.allclose(W.sum(-1), torch.ones(3, cfg.n_samples))
    with pytest.raises(ValueError, match="unknown mode"):
        tk.run_chains(_gen(0), _f32(v), _f32(c), cfg, "colapsed")
