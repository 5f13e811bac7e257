"""Posterior-sample clustering and per-value membership probabilities.

Port of ``basicrta_tpu.postprocess.clustering`` (the reference's
``Gibbs.cluster`` / ``process_gibbs``, gibbs.py:221-308, and the label
re-sorting of util.py:744-756): burn-in and weight-cutoff filtering, the
modal component count ``lmode``, a GMM on log(weight, rate) pairs, votes
of every event's regenerated component through the label map, and
relabelling by decreasing rate with noise clusters last. The host-side
helpers are numpy, as in the reference; the GMM and the votes run in torch
on the device of the caller's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops.random import multinomial
from basicrta_torch.postprocess.gmm import gmm_fit_predict


def component_counts(weights: np.ndarray, wcutoff: float) -> np.ndarray:
    """Number of components above the weight cutoff in each sample row."""
    return np.count_nonzero(np.asarray(weights) > wcutoff, axis=-1)


def select_lmode(lens: np.ndarray) -> int:
    """Modal surviving-component count (ties -> smallest)."""
    return int(np.bincount(lens).argmax())


def gather_cluster_data(weights: np.ndarray, rates: np.ndarray,
                        wcutoff: float, lmode: int):
    """Split post-burn-in samples into all/train (weight, rate) pairs.

    Returns:
        data (M, 2) above-cutoff pairs in (sample, component) order,
        inds (sample_idx, comp_idx), train (Mt, 2) pairs of samples with
        exactly ``lmode`` survivors.
    """
    weights = np.asarray(weights)
    rates = np.asarray(rates)
    above = weights > wcutoff
    inds = np.where(above)
    data = np.stack((weights[inds], rates[inds]), axis=1)
    train_rows = above.sum(axis=1) == lmode
    tmask = above[train_rows]
    train = np.stack((weights[train_rows][tmask],
                      rates[train_rows][tmask]), axis=1)
    return data, inds, train


@dataclasses.dataclass
class ClusterResult:
    """Output of :func:`process_samples`."""
    lmode: int                       # number of clusters
    labels: np.ndarray               # (M,) cluster label per surviving pair
    inds: Tuple[np.ndarray, np.ndarray]  # (sample, component) of each pair
    data: np.ndarray                 # (M, 2) surviving (weight, rate) pairs
    pindicator_values: Optional[np.ndarray] = None  # (V, lmode)
    presorts: Optional[np.ndarray] = None  # original label of sorted slot


def cluster_samples(generator: torch.Generator, weights_post: np.ndarray,
                    rates_post: np.ndarray, cfg: GibbsConfig,
                    n_events: int) -> ClusterResult:
    """Survivor filtering, lmode selection and GMM labelling."""
    wcutoff = cfg.wcutoff(n_events)
    lmode = select_lmode(component_counts(weights_post, wcutoff))
    data, inds, train = gather_cluster_data(weights_post, rates_post,
                                            wcutoff, lmode)
    dev = generator.device
    labels, _ = gmm_fit_predict(
        torch.log(torch.as_tensor(train, dtype=torch.float32, device=dev)),
        torch.log(torch.as_tensor(data, dtype=torch.float32, device=dev)),
        n_components=lmode, n_init=cfg.gmm_n_init, max_iter=cfg.gmm_max_iter,
        tol=cfg.gmm_tol, generator=generator)
    return ClusterResult(lmode=lmode,
                         labels=labels.cpu().numpy().astype(np.int32),
                         inds=inds, data=data)


def _label_matrix(inds, labels, shape) -> np.ndarray:
    """(S', K) matrix of cluster labels, -1 where weight <= wcutoff."""
    L = np.full(shape, -1, dtype=np.int32)
    L[inds] = labels
    return L


VOTE_CHUNK = 1 << 22    # (sample, value, component) entries per chunk


def votes_bucket(W, R, values, counts, labels, generators,
                 chunk_elems: int = VOTE_CHUNK) -> torch.Tensor:
    """Per-value cluster votes of a batch of residues, (B, V, K).

    For every saved sample, regenerate the per-value component counts
    ``m_v ~ Multinomial(c_v, z_v(w, r))`` and add them to the cluster of
    each labelled component (gibbs.py:259-272). W/R (B, S, K) samples,
    values/counts (B, V) (padding carries count 0), labels (B, S, K) ints
    (-1 votes for no cluster), one generator per residue. The one-hot is
    K wide, the chain's own component count, so no label < K loses its
    votes. Each residue's samples run in chunks of at most
    ``chunk_elems`` (sample, value, component) entries, a size set by its
    own shape only."""
    B, S, K = W.shape
    V = values.shape[1]
    step = max(1, chunk_elems // max(1, V * K))
    votes = torch.zeros((B, V, K), dtype=torch.float32, device=W.device)
    for s0 in range(0, S, step):
        w, r = W[:, s0:s0 + step], R[:, s0:s0 + step]
        n = w.shape[1]
        logz = (torch.log(w)[:, :, None, :] + torch.log(r)[:, :, None, :]
                - values[:, None, :, None] * r[:, :, None, :])
        m = multinomial(counts[:, None, :].expand(B, n, V),
                        torch.softmax(logz, -1), generators)
        onehot = torch.nn.functional.one_hot(
            labels[:, s0:s0 + step] + 1, K + 1)[..., 1:].to(torch.float32)
        votes += torch.einsum("bsvk,bskc->bvc", m, onehot)
    return votes


def accumulate_cluster_votes(generator: torch.Generator, weights_post,
                             rates_post, values, counts, label_matrix,
                             n_clusters: int,
                             chunk_elems: int = VOTE_CHUNK) -> np.ndarray:
    """One residue's per-unique-value cluster votes, (V, n_clusters)
    (:func:`votes_bucket` on a batch of one)."""
    dev = generator.device
    as_t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,  # noqa
                                         device=dev)[None]
    votes = votes_bucket(as_t(weights_post, torch.float32),
                         as_t(rates_post, torch.float32),
                         as_t(values, torch.float32),
                         as_t(counts, torch.float32),
                         as_t(label_matrix, torch.int64), [generator],
                         chunk_elems)
    return votes[0, :, :n_clusters].cpu().numpy()


def sort_labels_by_rate(result: ClusterResult,
                        noise_cutoff: float) -> ClusterResult:
    """Relabel clusters: non-noise by decreasing mean rate, noise last
    (noise: membership never exceeds ``noise_cutoff``, or no pairs)."""
    labels = result.labels
    arates = result.data[:, 1]
    pind = result.pindicator_values
    all_clusters = np.arange(pind.shape[1])
    present = np.isin(all_clusters, np.unique(labels))
    imaxs = pind.max(axis=0)
    noise_mask = (imaxs < noise_cutoff) | ~present
    means = np.array([arates[labels == i].mean() if present[i] else -np.inf
                      for i in all_clusters])
    non_noise = all_clusters[~noise_mask]
    noise = all_clusters[noise_mask]
    vsorts = means[non_noise].argsort()[::-1]
    nsorts = means[noise].argsort()[::-1]
    presorts = np.concatenate([non_noise[vsorts], noise[nsorts]]).astype(int)
    sorts = np.empty(len(all_clusters), dtype=int)
    sorts[presorts] = np.arange(len(all_clusters))
    result.labels = sorts[labels]
    result.pindicator_values = pind[:, presorts]
    result.presorts = presorts
    return result


def process_samples(generator: torch.Generator, mcweights, mcrates, values,
                    counts, cfg: GibbsConfig) -> ClusterResult:
    """Filter -> lmode -> GMM -> votes -> sort (gibbs.py:275-308)."""
    n_events = int(np.asarray(counts).sum())
    b = cfg.burnin_samples
    if b >= len(mcweights):
        raise ValueError(
            f"burn-in discards all samples ({b} thinned samples of burn-in "
            f"vs {len(mcweights)} collected); lower cfg.burnin or raise "
            f"cfg.niter")
    W = np.asarray(mcweights)[b:]
    R = np.asarray(mcrates)[b:]
    res = cluster_samples(generator, W, R, cfg, n_events)
    L = _label_matrix(res.inds, res.labels, W.shape)
    votes = accumulate_cluster_votes(generator, W, R, values, counts, L,
                                     res.lmode)
    denom = votes.sum(axis=1, keepdims=True)
    res.pindicator_values = votes / np.maximum(denom, 1e-30)
    return sort_labels_by_rate(res, cfg.noise_cutoff)
