"""Full-covariance Gaussian-mixture EM with batched restarts.

Port of ``basicrta_tpu.postprocess.gmm``: kmeans++ seeding plus Lloyd
refinement, then EM with convergence freezing; the ``n_init`` restarts are
a leading batch dimension and the restart with the best mean
log-likelihood labels the data (the reference's ``GaussianMixture(n_init=
117)`` fit-on-train / predict-on-all, gibbs.py:229-257).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GMMParams(NamedTuple):
    means: torch.Tensor        # (C, D)
    chols: torch.Tensor        # (C, D, D) Cholesky factors of covariances
    log_weights: torch.Tensor  # (C,)
    lower_bound: torch.Tensor  # () final mean log-likelihood


def _component_log_prob(X, means, chols):
    """log N(x | mu_c, Sigma_c): X (N, D), means (R, C, D), chols
    (R, C, D, D) -> (R, N, C)."""
    D = X.shape[-1]
    diff = X[None, None, :, :] - means[:, :, None, :]          # (R, C, N, D)
    y = torch.linalg.solve_triangular(chols, diff.transpose(-1, -2),
                                      upper=False)            # (R, C, D, N)
    maha = (y * y).sum(-2).transpose(-1, -2)                   # (R, N, C)
    logdet = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (maha + D * math.log(2 * math.pi)) - logdet[:, None, :]


def _choice(p, generator):
    """One index per row of the (R, N) non-negative weights ``p`` by
    inverse CDF; a row with no mass picks index 0."""
    cdf = torch.cumsum(p, -1)
    u = torch.rand(p.shape[0], 1, generator=generator, device=p.device,
                   dtype=p.dtype) * cdf[:, -1:]
    idx = torch.searchsorted(cdf, u, right=True).squeeze(-1)
    return torch.clamp(idx, max=p.shape[1] - 1)


def _kmeanspp_init(X, sw, n_components: int, n_init: int, generator,
                   lloyd_iters: int = 10):
    """kmeans++ seeding + Lloyd refinement per restart; (R, C, D)."""
    R = n_init
    first = _choice(sw.expand(R, -1), generator)
    centers = [X[first]]                                       # (R, D)
    d2min = ((X[None] - X[first][:, None]) ** 2).sum(-1)       # (R, N)
    for _ in range(n_components - 1):
        p = sw[None] * d2min
        p = torch.where(torch.isfinite(p), p, 0.0)
        nxt = _choice(p, generator)
        centers.append(X[nxt])
        d2min = torch.minimum(d2min,
                              ((X[None] - X[nxt][:, None]) ** 2).sum(-1))
    centers = torch.stack(centers, 1)                          # (R, C, D)
    prev = torch.full((R, X.shape[0]), -1, dtype=torch.int64,
                      device=X.device)
    active = torch.ones(R, dtype=torch.bool, device=X.device)
    for _ in range(lloyd_iters):
        d2 = ((X[None, :, None, :] - centers[:, None]) ** 2).sum(-1)
        assign = d2.argmin(-1)                                 # (R, N)
        onehot = torch.nn.functional.one_hot(assign, n_components).to(
            X.dtype) * sw[None, :, None]
        tot = onehot.sum(1)                                    # (R, C)
        new = (onehot.transpose(1, 2) @ X) / torch.clamp_min(tot, 1e-12)[
            ..., None]
        new = torch.where(tot[..., None] > 0, new, centers)
        centers = torch.where(active[:, None, None], new, centers)
        # a restart whose assignment stopped changing is at a fixed point
        active = active & ~(assign == prev).all(-1)
        prev = assign
        if not bool(active.any()):
            break
    return centers


def _m_step(X, sw, resp, reg_covar: float):
    """Weighted M-step for every restart; resp (R, N, C)."""
    D = X.shape[-1]
    wresp = resp * sw[None, :, None]
    Nk = torch.clamp_min(wresp.sum(1), 10 * torch.finfo(X.dtype).eps)
    means = (wresp.transpose(1, 2) @ X) / Nk[..., None]        # (R, C, D)
    diff = X[None, :, None, :] - means[:, None]                # (R, N, C, D)
    covs = torch.einsum("rnc,rncd,rnce->rcde", wresp, diff, diff) / Nk[
        ..., None, None]
    covs = covs + reg_covar * torch.eye(D, dtype=X.dtype, device=X.device)
    chols, info = torch.linalg.cholesky_ex(covs)
    # a factorisation that fails is NaN, as in the reference: its restart
    # ends with a NaN bound and never wins
    chols = torch.where((info != 0)[..., None, None], float("nan"), chols)
    log_w = torch.log(Nk / Nk.sum(-1, keepdim=True))
    return means, chols, log_w


def _em_restarts(X, sw, n_components: int, n_init: int, max_iter: int,
                 tol: float, reg_covar: float, generator) -> GMMParams:
    """``_em_single`` of the reference for all ``n_init`` restarts at
    once, with convergence freezing: a restart whose bound moved less than
    ``tol`` (or went NaN) keeps its parameters; the loop ends when every
    restart is done. Returns GMMParams with a leading restart axis."""
    centers = _kmeanspp_init(X, sw, n_components, n_init, generator)
    d2 = ((X[None, :, None, :] - centers[:, None]) ** 2).sum(-1)
    resp = torch.nn.functional.one_hot(d2.argmin(-1), n_components).to(
        X.dtype)
    means, chols, log_w = _m_step(X, sw, resp, reg_covar)
    prev_lb = torch.full((n_init,), -math.inf, dtype=X.dtype,
                         device=X.device)
    done = torch.zeros(n_init, dtype=torch.bool, device=X.device)
    for _ in range(max_iter):
        logp = _component_log_prob(X, means, chols) + log_w[:, None, :]
        lse = torch.logsumexp(logp, -1)                        # (R, N)
        lb = (sw[None] * lse).sum(-1) / sw.sum()
        resp = torch.exp(logp - lse[..., None])
        n_means, n_chols, n_log_w = _m_step(X, sw, resp, reg_covar)
        now_done = done | ((lb - prev_lb).abs() < tol) | torch.isnan(lb)
        means = torch.where(done[:, None, None], means, n_means)
        chols = torch.where(done[:, None, None, None], chols, n_chols)
        log_w = torch.where(done[:, None], log_w, n_log_w)
        prev_lb = torch.where(done, prev_lb, lb)
        done = now_done
        if bool(done.all()):
            break
    lb = torch.where(torch.isnan(prev_lb), -math.inf, prev_lb)
    return GMMParams(means, chols, log_w, lb)


def gmm_fit_predict(train, data, n_components: int, n_init: int = 117,
                    max_iter: int = 100, tol: float = 1e-3,
                    reg_covar: float = 1e-6, generator=None):
    """Fit a full-covariance GMM on ``train`` (M, D) and label ``data``:
    the restart with the best mean log-likelihood labels every point.

    Returns:
        (labels (M,) int64, GMMParams of the winning restart)
    """
    X = train.to(torch.float32)
    sw = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    fits = _em_restarts(X, sw, n_components, n_init, max_iter, tol,
                        reg_covar, generator)
    best = int(torch.argmax(fits.lower_bound))
    params = GMMParams(*(f[best] for f in fits))
    logp = (_component_log_prob(data.to(torch.float32), params.means[None],
                                params.chols[None])
            + params.log_weights[None, None, :])[0]
    return logp.argmax(-1), params
