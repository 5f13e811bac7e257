"""Full-covariance Gaussian-mixture EM with batched restarts.

Port of ``basicrta_tpu.postprocess.gmm``: kmeans++ seeding plus Lloyd
refinement, then EM with convergence freezing; the ``n_init`` restarts are
a batch dimension and the restart with the best mean log-likelihood labels
the data (the reference's ``GaussianMixture(n_init=117)`` fit-on-train /
predict-on-all, gibbs.py:229-257).

Every function carries a leading residue axis B, so one EM runs the
restarts of many residues at once (``postprocess.batched``): the loops
synchronise with the host once per iteration for the whole batch. Padded
training rows take weight 0 in ``sw``. The kmeans++ draws come in as
uniforms, one (C, n_init) block per residue drawn from that residue's own
generator, so a residue's fit does not depend on its batch mates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GMMParams(NamedTuple):
    means: torch.Tensor        # (..., C, D)
    chols: torch.Tensor        # (..., C, D, D) Cholesky factors
    log_weights: torch.Tensor  # (..., C)
    lower_bound: torch.Tensor  # (...) final mean log-likelihood


def _component_log_prob(X, means, chols):
    """log N(x | mu_c, Sigma_c): X (B, N, D), means (B, R, C, D), chols
    (B, R, C, D, D) -> (B, R, N, C)."""
    D = X.shape[-1]
    diff = X[:, None, None] - means[..., None, :]          # (B, R, C, N, D)
    y = torch.linalg.solve_triangular(chols, diff.transpose(-1, -2),
                                      upper=False)         # (B, R, C, D, N)
    maha = (y * y).sum(-2).transpose(-1, -2)               # (B, R, N, C)
    logdet = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (maha + D * math.log(2 * math.pi)) - logdet[..., None, :]


def _choice(p, u):
    """One index per row of the (B, R, N) non-negative weights ``p`` by
    inverse CDF at the uniforms ``u`` (B, R); no mass picks index 0."""
    cdf = torch.cumsum(p, -1)
    idx = torch.searchsorted(cdf, (u * cdf[..., -1])[..., None],
                             right=True).squeeze(-1)
    return torch.clamp(idx, max=p.shape[-1] - 1)


def _take(X, idx):
    """Rows ``X[b, idx[b, r]]``: X (B, N, D), idx (B, R) -> (B, R, D)."""
    D = X.shape[-1]
    return torch.gather(X, 1, idx[..., None].expand(-1, -1, D))


def _kmeanspp_init(X, sw, n_components: int, uniforms,
                   lloyd_iters: int = 10):
    """kmeans++ seeding + Lloyd refinement per restart; X (B, N, D), sw
    (B, N), uniforms (B, C, R) -> centers (B, R, C, D)."""
    B, R = X.shape[0], uniforms.shape[-1]
    first = _choice(sw[:, None].expand(B, R, -1), uniforms[:, 0])
    c0 = _take(X, first)
    centers = [c0]
    d2min = ((X[:, None] - c0[:, :, None]) ** 2).sum(-1)    # (B, R, N)
    for c in range(1, n_components):
        p = sw[:, None] * d2min
        p = torch.where(torch.isfinite(p), p, 0.0)
        nxt = _take(X, _choice(p, uniforms[:, c]))
        centers.append(nxt)
        d2min = torch.minimum(d2min, ((X[:, None] - nxt[:, :, None]) ** 2
                                      ).sum(-1))
    centers = torch.stack(centers, 2)                       # (B, R, C, D)
    prev = torch.full(d2min.shape, -1, dtype=torch.int64, device=X.device)
    active = torch.ones((B, R), dtype=torch.bool, device=X.device)
    for _ in range(lloyd_iters):
        d2 = ((X[:, None, :, None] - centers[:, :, None]) ** 2).sum(-1)
        assign = d2.argmin(-1)                              # (B, R, N)
        onehot = torch.nn.functional.one_hot(assign, n_components).to(
            X.dtype) * sw[:, None, :, None]
        tot = onehot.sum(2)                                 # (B, R, C)
        new = (onehot.transpose(-1, -2) @ X[:, None]) / torch.clamp_min(
            tot, 1e-12)[..., None]
        new = torch.where(tot[..., None] > 0, new, centers)
        centers = torch.where(active[..., None, None], new, centers)
        # a restart whose assignment stopped changing is at a fixed point
        active = active & ~(assign == prev).all(-1)
        prev = assign
        if not bool(active.any()):
            break
    return centers


def _m_step(X, sw, resp, reg_covar: float):
    """Weighted M-step for every restart; X (B, N, D), resp (B, R, N, C)."""
    D = X.shape[-1]
    wresp = resp * sw[:, None, :, None]
    Nk = torch.clamp_min(wresp.sum(2), 10 * torch.finfo(X.dtype).eps)
    means = (wresp.transpose(-1, -2) @ X[:, None]) / Nk[..., None]
    diff = X[:, None, :, None] - means[:, :, None]          # (B, R, N, C, D)
    covs = torch.einsum("brncd,brnce->brcde", wresp[..., None] * diff,
                        diff) / Nk[..., None, None]
    covs = covs + reg_covar * torch.eye(D, dtype=X.dtype, device=X.device)
    chols, info = torch.linalg.cholesky_ex(covs)
    # a factorisation that fails is NaN, as in the reference: its restart
    # ends with a NaN bound and never wins
    chols = torch.where((info != 0)[..., None, None], float("nan"), chols)
    log_w = torch.log(Nk / Nk.sum(-1, keepdim=True))
    return means, chols, log_w


def _em_restarts(X, sw, n_components: int, max_iter: int, tol: float,
                 reg_covar: float, uniforms) -> GMMParams:
    """``_em_single`` of the reference for every (residue, restart) at
    once, with convergence freezing: a restart whose bound moved less than
    ``tol`` (or went NaN) keeps its parameters; the loop ends when every
    restart of every residue is done. X (B, N, D), sw (B, N), uniforms
    (B, C, R); returns GMMParams with leading (B, R) axes."""
    centers = _kmeanspp_init(X, sw, n_components, uniforms)
    d2 = ((X[:, None, :, None] - centers[:, :, None]) ** 2).sum(-1)
    resp = torch.nn.functional.one_hot(d2.argmin(-1), n_components).to(
        X.dtype)
    means, chols, log_w = _m_step(X, sw, resp, reg_covar)
    shape = centers.shape[:2]
    prev_lb = torch.full(shape, -math.inf, dtype=X.dtype, device=X.device)
    done = torch.zeros(shape, dtype=torch.bool, device=X.device)
    total_w = sw.sum(-1)[:, None]
    for _ in range(max_iter):
        logp = _component_log_prob(X, means, chols) + log_w[..., None, :]
        lse = torch.logsumexp(logp, -1)                    # (B, R, N)
        lb = (sw[:, None] * lse).sum(-1) / total_w
        resp = torch.exp(logp - lse[..., None])
        n_means, n_chols, n_log_w = _m_step(X, sw, resp, reg_covar)
        now_done = done | ((lb - prev_lb).abs() < tol) | torch.isnan(lb)
        means = torch.where(done[..., None, None], means, n_means)
        chols = torch.where(done[..., None, None, None], chols, n_chols)
        log_w = torch.where(done[..., None], log_w, n_log_w)
        prev_lb = torch.where(done, prev_lb, lb)
        done = now_done
        if bool(done.all()):
            break
    lb = torch.where(torch.isnan(prev_lb), -math.inf, prev_lb)
    return GMMParams(means, chols, log_w, lb)


def fit_predict_batched(train, train_w, data, n_components: int,
                        uniforms, max_iter: int = 100, tol: float = 1e-3,
                        reg_covar: float = 1e-6):
    """Fit a GMM per residue on ``train`` (B, Mt, D) with row weights
    ``train_w`` (B, Mt) and label ``data`` (B, M, D) with each residue's
    best restart. ``uniforms`` (B, C, n_init) seed kmeans++.

    Returns:
        (labels (B, M) int64, GMMParams of each residue's winning restart)
    """
    X = train.to(torch.float32)
    fits = _em_restarts(X, train_w.to(torch.float32), n_components,
                        max_iter, tol, reg_covar, uniforms)
    best = torch.argmax(fits.lower_bound, -1)              # (B,)
    rows = torch.arange(X.shape[0], device=X.device)
    params = GMMParams(*(f[rows, best] for f in fits))
    logp = (_component_log_prob(data.to(torch.float32),
                                params.means[:, None],
                                params.chols[:, None])[:, 0]
            + params.log_weights[:, None, :])
    return logp.argmax(-1), params


def gmm_fit_predict(train, data, n_components: int, n_init: int = 117,
                    max_iter: int = 100, tol: float = 1e-3,
                    reg_covar: float = 1e-6, generator=None):
    """Fit a full-covariance GMM on ``train`` (M, D) and label ``data``:
    the restart with the best mean log-likelihood labels every point.

    Returns:
        (labels (M,) int64, GMMParams of the winning restart)
    """
    u = torch.rand((1, n_components, n_init), generator=generator,
                   device=train.device)
    labels, params = fit_predict_batched(
        train[None], torch.ones((1, train.shape[0]), device=train.device),
        data[None], n_components, u, max_iter, tol, reg_covar)
    return labels[0], GMMParams(*(p[0] for p in params))
