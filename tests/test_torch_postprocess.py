"""basicrta_torch.postprocess against the JAX package: the deterministic
helpers equal its outputs on the same (W, R) and labels, and the random
stages (GMM restarts, votes) reach the same clusters and tau."""

import jax
import numpy as np
import pytest
import torch

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.ops.surv import discretize_times, simulate_hyperexp
from basicrta_tpu.postprocess import clustering as jclu
from basicrta_tpu.postprocess import gmm as jgmm
from basicrta_tpu.postprocess import tau as jtau
from basicrta_torch.ops.random import multinomial
from basicrta_torch.postprocess import clustering as clu
from basicrta_torch.postprocess import gmm
from basicrta_torch.postprocess import tau as ptau


def _chains(seed, S=300, K=5):
    """Well-separated synthetic posterior: a fast (w 0.8, r 2) and a slow
    (w 0.2, r 0.05) component, the rest below the weight cutoff; an
    occasional third live component varies the per-sample count."""
    rng = np.random.default_rng(seed)
    W = np.full((S, K), 1e-6)
    R = rng.uniform(0.5, 5.0, (S, K))
    W[:, 0] = rng.normal(0.8, 0.01, S)
    W[:, 1] = rng.normal(0.2, 0.01, S)
    R[:, 0] = rng.lognormal(np.log(2.0), 0.03, S)
    R[:, 1] = rng.lognormal(np.log(0.05), 0.05, S)
    extra = rng.random(S) < 0.2
    W[extra, 2] = 0.01
    return W.astype(np.float32), R.astype(np.float32)


def _data(seed):
    x = discretize_times(simulate_hyperexp(
        4000, [0.8, 0.2], [2.0, 0.05], np.random.default_rng(seed)), 0.1)
    return np.unique(x, return_counts=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deterministic_helpers_equal_jax(seed):
    W, R = _chains(seed)
    wcut = 10.0 / 4000
    lens = clu.component_counts(W, wcut)
    np.testing.assert_array_equal(lens, jclu.component_counts(W, wcut))
    lmode = clu.select_lmode(lens)
    assert lmode == jclu.select_lmode(lens) == 2
    got = clu.gather_cluster_data(W, R, wcut, lmode)
    ref = jclu.gather_cluster_data(W, R, wcut, lmode)
    for a, b in zip((got[0], *got[1], got[2]), (ref[0], *ref[1], ref[2])):
        np.testing.assert_array_equal(a, b)
    data, inds, _ = got
    labels = np.where(data[:, 1] > 0.5, 1, 0).astype(np.int32)
    labels[np.random.default_rng(seed).random(len(labels)) < 0.01] = 2
    np.testing.assert_array_equal(clu._label_matrix(inds, labels, W.shape),
                                  jclu._label_matrix(inds, labels, W.shape))
    pind = np.random.default_rng(seed).dirichlet(np.ones(3), 50)
    pind[:, 2] *= 0.1
    res = clu.sort_labels_by_rate(
        clu.ClusterResult(3, labels.copy(), inds, data, pind.copy()), 0.4)
    jres = jclu.sort_labels_by_rate(
        jclu.ClusterResult(3, labels.copy(), inds, data, pind.copy()), 0.4)
    for f in ("labels", "pindicator_values", "presorts"):
        np.testing.assert_array_equal(getattr(res, f), getattr(jres, f))
    params, intervals = ptau.estimate_params(res)
    jparams, jintervals = jtau.estimate_params(jres)
    np.testing.assert_array_equal(params, jparams)
    np.testing.assert_array_equal(intervals, jintervals)
    assert ptau.estimate_tau(res, 0.4) == jtau.estimate_tau(jres, 0.4)


def test_estimate_tau_all_noise_raises():
    W, R = _chains(0)
    data, inds, _ = clu.gather_cluster_data(W, R, 1e-3, 2)
    res = clu.ClusterResult(2, np.zeros(len(data), np.int32), inds, data,
                            np.full((10, 2), 0.1))
    with pytest.raises(ptau.AllNoiseError):
        ptau.estimate_tau(res, 0.4)


def test_gmm_matches_jax_partition():
    """Two well-separated blobs: every restart finds them, so the port's
    labels equal the JAX fit's up to a permutation."""
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal([0, 0], 0.1, (200, 2)),
                        rng.normal([3, 1], 0.2, (100, 2))]).astype(
                            np.float32)
    labels, params = gmm.gmm_fit_predict(
        torch.from_numpy(X), torch.from_numpy(X), 2, n_init=8,
        generator=torch.Generator().manual_seed(0))
    jlabels, _ = jgmm.gmm_fit_predict(jax.random.key(0), X, X, 2, n_init=8)
    labels, jlabels = labels.numpy(), np.asarray(jlabels)
    assert len(set(zip(labels.tolist(), jlabels.tolist()))) == 2
    np.testing.assert_allclose(np.sort(params.means[:, 0].numpy()),
                               [0.0, 3.0], atol=0.05)
    assert np.isfinite(params.lower_bound.item())


def test_multinomial_conserves_counts_and_mean():
    gen = torch.Generator().manual_seed(1)
    counts = torch.tensor([[0.0, 1.0, 5.0, 40.0, 1000.0]] * 400)
    probs = torch.softmax(torch.tensor([0.3, -1.0, 2.0, 0.0]), 0).expand(
        400, 5, 4)
    m = multinomial(counts, probs, gen)
    assert torch.equal(m.sum(-1), counts)
    assert (m >= 0).all()
    mean = m[:, 4].mean(0) / 1000.0
    np.testing.assert_allclose(mean.numpy(), probs[0, 0].numpy(), atol=0.01)


def test_votes_total_every_event_per_sample():
    values, counts = _data(3)
    W, R = _chains(3, S=40)
    L = np.where(W > 1e-3, np.arange(5)[None, :] % 2, 0).astype(np.int32)
    votes = clu.accumulate_cluster_votes(torch.Generator().manual_seed(0),
                                         W, R, values, counts, L, 2,
                                         chunk_elems=4096)
    np.testing.assert_array_equal(votes.sum(1), counts * 40.0)
    # long residence times vote for the slow component's cluster
    assert votes[-1, 1] > votes[-1, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_process_samples_matches_jax(seed):
    values, counts = _data(seed)
    W, R = _chains(seed + 10)
    cfg = GibbsConfig(ncomp=5, niter=3000, g=10, burnin=0, gmm_n_init=8)
    res = clu.process_samples(torch.Generator().manual_seed(seed), W, R,
                              values, counts, cfg)
    jres = jclu.process_samples(jax.random.key(seed), W, R, values, counts,
                                cfg)
    assert res.lmode == jres.lmode == 2
    tau = ptau.estimate_tau(res, cfg.noise_cutoff)
    jt = jtau.estimate_tau(jres, cfg.noise_cutoff)
    assert tau[1] == pytest.approx(jt[1], rel=0.05)
    assert tau[1] == pytest.approx(20.0, rel=0.1)
    np.testing.assert_allclose(res.pindicator_values.sum(1), 1.0, atol=1e-5)
