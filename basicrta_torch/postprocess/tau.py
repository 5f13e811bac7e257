"""Cluster parameter point estimates and residence-time (tau) estimation.

Port of ``basicrta_tpu.postprocess.tau`` (host numpy, reference
gibbs.py:667-715): per-cluster point estimates are the left edge of the
tallest of 20 log-spaced bins; tau of the slowest non-noise process is the
midpoint of the tallest of 15 linear bins of its 1/rate samples, with an
empirical 95% credible interval; ``estimate_tau_all`` gives the same
estimate for every non-noise cluster.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from basicrta_torch.ops.surv import empirical_ci
from basicrta_torch.postprocess.clustering import ClusterResult


class AllNoiseError(RuntimeError):
    """Raised when every cluster is classified as noise."""


def _log_hist_mode(samples: np.ndarray, nbins: int = 20) -> float:
    """Left edge of the tallest log-spaced histogram bin."""
    bins = np.exp(np.linspace(np.log(samples.min()), np.log(samples.max()),
                              nbins))
    hist, edges = np.histogram(samples, bins=bins)
    return float(edges[np.argmax(hist)])


def estimate_params(result: ClusterResult):
    """Per-cluster (weight, rate) modes (lmode, 2) and 95% CIs
    (2, lmode, 2)."""
    w, r, labels = result.data[:, 0], result.data[:, 1], result.labels
    params, wits, rits = [], [], []
    for i in range(result.lmode):
        wi, ri = w[labels == i], r[labels == i]
        if wi.size == 0:
            params.append([np.nan, np.nan])
            wits.append([np.nan, np.nan])
            rits.append([np.nan, np.nan])
            continue
        params.append([_log_hist_mode(wi), _log_hist_mode(ri)])
        wits.append(empirical_ci(wi))
        rits.append(empirical_ci(ri))
    return np.asarray(params), np.asarray([wits, rits])


def estimate_tau(result: ClusterResult, noise_cutoff: float,
                 params: Optional[np.ndarray] = None,
                 nbins: int = 15) -> Tuple[float, float, float]:
    """(ci_lo, tau_max, ci_hi) of the slowest non-noise process: the
    present, non-noise cluster with the smallest finite rate estimate."""
    if params is None:
        params, _ = estimate_params(result)
    imaxs = result.pindicator_values.max(axis=0)
    all_clusters = np.arange(result.lmode)
    present = np.isin(all_clusters, np.unique(result.labels))
    candidates = all_clusters[present & (imaxs >= noise_cutoff)]
    candidates = candidates[np.isfinite(params[candidates, 1])]
    if candidates.size == 0:
        raise AllNoiseError("all clusters classified as noise")
    slowest = candidates[np.argmin(params[candidates, 1])]
    taus = 1.0 / result.data[result.labels == slowest, 1]
    lo, hi = empirical_ci(taus)
    hist, edges = np.histogram(taus, bins=nbins)
    imax = int(np.argmax(hist))
    val = 0.5 * (edges[imax] + edges[imax + 1])
    return float(lo), float(val), float(hi)


def estimate_tau_all(result: ClusterResult, noise_cutoff: float,
                     params: Optional[np.ndarray] = None,
                     nbins: int = 15) -> np.ndarray:
    """(C, 4) rows ``[cluster, ci_lo, tau_max, ci_hi]``, one per present,
    non-noise cluster with a finite rate estimate, slowest process first
    (ascending rate). Raises AllNoiseError when no cluster survives."""
    if params is None:
        params, _ = estimate_params(result)
    imaxs = result.pindicator_values.max(axis=0)
    all_clusters = np.arange(result.lmode)
    present = np.isin(all_clusters, np.unique(result.labels))
    candidates = all_clusters[present & (imaxs >= noise_cutoff)]
    candidates = candidates[np.isfinite(params[candidates, 1])]
    if candidates.size == 0:
        raise AllNoiseError("all clusters classified as noise")
    rows = []
    for c in candidates[np.argsort(params[candidates, 1])]:
        taus = 1.0 / result.data[result.labels == c, 1]
        lo, hi = empirical_ci(taus)
        hist, edges = np.histogram(taus, bins=nbins)
        imax = int(np.argmax(hist))
        rows.append([float(c), float(lo),
                     0.5 * (edges[imax] + edges[imax + 1]), float(hi)])
    return np.asarray(rows, np.float64)
