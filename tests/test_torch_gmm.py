"""The port's Gaussian-mixture EM (``basicrta_torch.postprocess.gmm``)
against the JAX package's, on the cases of ``tests/test_gmm.py``.

The two packages draw the kmeans++ seeds from different generators, so:

- the deterministic pieces take the same inputs in both and agree to f32
  rounding (rtol 1e-5): ``_component_log_prob`` and ``_m_step``;
- the port's kmeans++ schedule (running minimum, Lloyd frozen at its fixed
  point) is bitwise the original full-matrix seeding with fixed-length
  Lloyd on the same uniforms, as the JAX test requires of its own;
- the fits agree in law: both label the blobs, the port agrees with
  sklearn's ``GaussianMixture`` and with the JAX labels on more than 98%
  of the points (best permutation), and zero-weight padding changes
  neither the port's labels nor its fitted parameters (f32 rounding)."""

from itertools import permutations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrta_tpu.postprocess import gmm as jg

from basicrta_torch.postprocess import gmm as tg


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(seed=0, n_per=300):
    """Three 2-D Gaussian blobs (the JAX file's ``_blobs``)."""
    rng = np.random.default_rng(seed)
    means = np.array([[0.0, 0.0], [4.0, 4.0], [-4.0, 5.0]])
    covs = [np.array([[0.3, 0.1], [0.1, 0.2]]),
            np.array([[0.5, -0.2], [-0.2, 0.4]]),
            np.diag([0.2, 0.6])]
    X = np.concatenate([rng.multivariate_normal(m, c, n_per)
                        for m, c in zip(means, covs)])
    return X.astype(np.float32), np.repeat(np.arange(3), n_per)


def _agreement(a, b, k=3):
    return max(float(np.mean(np.asarray(p)[a] == b))
               for p in permutations(range(k)))


def _params(rng, C=3, D=2):
    means = rng.normal(0, 3, (C, D)).astype(np.float32)
    A = rng.normal(0, 0.5, (C, D, D))
    covs = A @ A.transpose(0, 2, 1) + 0.3 * np.eye(D)
    return means, np.linalg.cholesky(covs).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_component_log_prob_equal(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 3, (200, 2)).astype(np.float32)
    means, chols = _params(rng)
    want = np.asarray(jg._component_log_prob(jnp.asarray(X),
                                             jnp.asarray(means),
                                             jnp.asarray(chols)))
    got = tg._component_log_prob(torch.from_numpy(X)[None],
                                 torch.from_numpy(means)[None, None],
                                 torch.from_numpy(chols)[None, None])
    assert got.shape == (1, 1, 200, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0, 0].numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("weighted", [False, True])
def test_m_step_equal(seed, weighted):
    rng = np.random.default_rng(10 + seed)
    X, _ = _blobs(seed, n_per=60)
    resp = rng.dirichlet(np.ones(3), len(X)).astype(np.float32)
    sw = (rng.uniform(0, 2, len(X)) if weighted
          else np.ones(len(X))).astype(np.float32)
    want = jg._m_step(jnp.asarray(X), jnp.asarray(sw), jnp.asarray(resp),
                      1e-6)
    got = tg._m_step(torch.from_numpy(X)[None], torch.from_numpy(sw)[None],
                     torch.from_numpy(resp)[None, None], 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0, 0].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


def _original_kmeanspp(X, sw, C, u, lloyd_iters=10):
    """The original schedule on the port's draws: every chosen centre's
    distances in one matrix, minimum over the chosen ones, and all
    ``lloyd_iters`` Lloyd steps (no freezing). X (N, D), u (C, R)."""
    R = u.shape[1]
    out = []
    for r in range(R):
        idx = tg._choice(sw[None, None], u[0, r][None, None])[0, 0]
        centers = X[idx].repeat(C, 1)
        for c in range(1, C):
            d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
            d2 = d2 + torch.where(torch.arange(C)[None] < c, 0.0,
                                  float("inf"))
            p = sw * d2.min(1).values
            p = torch.where(torch.isfinite(p), p, 0.0)
            centers[c] = X[tg._choice(p[None, None], u[c, r][None, None])
                           [0, 0]]
        for _ in range(lloyd_iters):
            d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
            onehot = torch.nn.functional.one_hot(d2.argmin(1), C).to(
                X.dtype) * sw[:, None]
            tot = onehot.sum(0)
            new = (onehot.T[None] @ X[None])[0] / torch.clamp_min(
                tot, 1e-12)[:, None]
            centers = torch.where(tot[:, None] > 0, new, centers)
        out.append(centers)
    return torch.stack(out)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_kmeanspp_bitwise_matches_original_schedule(seed):
    X = torch.from_numpy(_blobs()[0])
    sw = torch.ones(len(X))
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((1, 4, 5), generator=g)
    got = tg._kmeanspp_init(X[None], sw[None], 4, u)[0]
    want = _original_kmeanspp(X, sw, 4, u[0])
    assert torch.equal(got, want)


def test_gmm_separates_blobs_like_jax():
    X, y = _blobs()
    labels, params = tg.gmm_fit_predict(
        torch.from_numpy(X), torch.from_numpy(X), n_components=3, n_init=8,
        max_iter=60, generator=torch.Generator().manual_seed(0))
    jl, jp = jg.gmm_fit_predict(jax.random.key(0), jnp.asarray(X),
                                jnp.asarray(X), n_components=3, n_init=8,
                                max_iter=60)
    assert _agreement(labels.numpy(), y) > 0.98
    assert _agreement(labels.numpy(), np.asarray(jl)) > 0.98
    assert np.isfinite(float(params.lower_bound))
    # the winning bounds of two fits of the same data: f32 and seeding
    assert float(params.lower_bound) == pytest.approx(
        float(jp.lower_bound), rel=1e-3)


def test_gmm_matches_sklearn():
    sklearn = pytest.importorskip("sklearn.mixture")
    X, _ = _blobs(1)
    ours, _ = tg.gmm_fit_predict(torch.from_numpy(X), torch.from_numpy(X),
                                 n_components=3, n_init=8,
                                 generator=torch.Generator().manual_seed(1))
    sk = sklearn.GaussianMixture(n_components=3, n_init=8,
                                 random_state=0).fit_predict(X)
    assert _agreement(ours.numpy(), sk) > 0.98


def test_gmm_sample_weights():
    """Zero-weight padding does not move the fit: the same labels and, to
    f32 rounding, the same parameters as the unpadded fit on the same
    uniforms; the JAX test's agreement with the truth on the port."""
    X, y = _blobs(2)
    rng = np.random.default_rng(2)
    pad = rng.normal(50.0, 1.0, size=(100, 2)).astype(np.float32)
    Xp = torch.from_numpy(np.concatenate([X, pad]))[None]
    w = torch.cat([torch.ones(len(X)), torch.zeros(len(pad))])[None]
    u = torch.rand((1, 3, 8), generator=torch.Generator().manual_seed(2))
    data = torch.from_numpy(X)[None]
    lp, pp = tg.fit_predict_batched(Xp, w, data, 3, u)
    lu, pu = tg.fit_predict_batched(data, torch.ones((1, len(X))), data, 3,
                                    u)
    assert _agreement(lp[0].numpy(), y) > 0.98
    assert torch.equal(lp, lu)
    for a, b in zip(pp, pu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    jl, _ = jg.gmm_fit_predict(jax.random.key(2), jnp.asarray(Xp[0].numpy()),
                               jnp.asarray(X), n_components=3, n_init=8,
                               train_weights=jnp.asarray(w[0].numpy()))
    assert _agreement(lp[0].numpy(), np.asarray(jl)) > 0.98
