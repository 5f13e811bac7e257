"""MCMC convergence diagnostics of multi-chain runs (numpy).

The port's own copy of the JAX package's ``ops.diagnostics``: split-R̂
(Vehtari et al. 2021) and bulk effective sample size by Geyer's initial
monotone sequence, on the thinned (C, S, K) sample arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["split_rhat", "effective_sample_size", "convergence_report",
           "chain_report"]


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(C, S, ...) -> (2C, S//2, ...); drops the last draw of odd S."""
    S = x.shape[1]
    half = S // 2
    if half < 2:
        raise ValueError(f"need >= 4 post-burn-in draws per chain, got {S}")
    return np.concatenate([x[:, :half], x[:, S - half:]], axis=0)


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-R̂ over the leading (chain, draw) axes of (C, S, ...) draws,
    with the trailing parameter shape."""
    x = _split_chains(np.asarray(samples, np.float64))
    n = x.shape[1]
    means = x.mean(axis=1)
    W = x.var(axis=1, ddof=1).mean(axis=0)        # within-chain
    B = n * means.var(axis=0, ddof=1)             # between-chain
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / W)
    # constant-across-everything parameters are trivially converged
    return np.where((W == 0) & (B == 0), 1.0, rhat)


def _autocov(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance by FFT, (C, S, ...) -> (C, S, ...)."""
    S = x.shape[1]
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = 1
    while nfft < 2 * S:
        nfft *= 2
    f = np.fft.rfft(xc, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :S]
    return acov / S


def effective_sample_size(samples: np.ndarray) -> np.ndarray:
    """Bulk ESS over the leading (chain, draw) axes, capped at the total
    draw count."""
    x = _split_chains(np.asarray(samples, np.float64))
    m, n = x.shape[0], x.shape[1]
    acov = _autocov(x)
    W = acov[:, 0].mean(axis=0)
    means = x.mean(axis=1)
    var_plus = (n - 1) / n * W + means.var(axis=0, ddof=1)
    flat_shape = var_plus.shape
    rho = 1.0 - (W - acov.mean(axis=0)) / np.where(var_plus == 0, 1.0,
                                                   var_plus)
    rho = rho.reshape(n, -1)
    ess = np.empty(rho.shape[1])
    for j in range(rho.shape[1]):
        r = rho[:, j]
        # Geyer: tau = -1 + 2 * sum of consecutive (rho_2t + rho_2t+1)
        # pairs while positive, enforced monotone non-increasing
        t = 0
        psum = 0.0
        prev = np.inf
        while t + 1 < n:
            pair = r[t] + r[t + 1]
            if pair < 0:
                break
            pair = min(pair, prev)
            psum += pair
            prev = pair
            t += 2
        tau = 2.0 * psum - 1.0
        ess[j] = m * n / max(tau, 1.0 / (m * n))
    return np.minimum(ess.reshape(flat_shape), float(m * n))


def convergence_report(mcweights: np.ndarray, mcrates: np.ndarray,
                       burnin_samples: int = 0,
                       wcutoff: Optional[float] = None) -> Dict[str, object]:
    """Max split-R̂ and min bulk ESS of one residue's (C, S, K) thinned
    chains after burn-in, over the components whose posterior-mean weight
    exceeds ``wcutoff`` (all of them without one), plus the per-array
    values."""
    W = np.asarray(mcweights)[:, burnin_samples:]
    R = np.asarray(mcrates)[:, burnin_samples:]
    if wcutoff is not None:
        live = W.mean(axis=(0, 1)) > wcutoff
        if live.any():
            W, R = W[..., live], R[..., live]
    rw, rr = split_rhat(W), split_rhat(np.log(R))
    ew, er = effective_sample_size(W), effective_sample_size(np.log(R))
    return {
        "max_rhat": float(np.nanmax([rw.max(), rr.max()])),
        "min_ess": float(np.nanmin([ew.min(), er.min()])),
        "rhat_weights": rw, "rhat_rates": rr,
        "ess_weights": ew, "ess_rates": er,
    }


def chain_report(mcweights: np.ndarray, mcrates: np.ndarray,
                 burnin_samples: int = 0) -> dict:
    """Per-component split-R̂ and bulk ESS of a residue's (chains, S, K)
    samples after burn-in (the rates on their own scale)."""
    W = np.asarray(mcweights)[:, burnin_samples:]
    R = np.asarray(mcrates)[:, burnin_samples:]
    return {
        "rhat_weights": split_rhat(W),
        "rhat_rates": split_rhat(R),
        "ess_weights": effective_sample_size(W),
        "ess_rates": effective_sample_size(R),
    }
