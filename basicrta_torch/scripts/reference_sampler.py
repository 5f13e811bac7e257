"""The reference model's per-event Gibbs sweep in numpy.

A copy of the JAX package's ``numpy_reference_sampler``
(``tests/test_equivalence.py``): the semantics of reference
gibbs.py:191-217 (responsibilities, a categorical indicator per event,
conjugate Dirichlet/Gamma draws) written independently of both packages'
samplers, on numpy's PCG64. The port's engines must give posteriors that
match it in law (``scripts/validate.py``, ``tests/test_torch_equivalence.py``).
"""

from __future__ import annotations

import numpy as np

from basicrta_torch.config import GibbsConfig


def numpy_reference_sampler(x, cfg: GibbsConfig, seed=0):
    """Per-event conjugate Gibbs sweeps with numpy's PCG64 — the reference
    model's semantics, written independently (same math, fresh code)."""
    rng = np.random.default_rng(seed)
    K = cfg.ncomp
    alpha = np.full(K, cfg.alpha_eff)
    a, b = cfg.gamma_shape, cfg.gamma_rate
    inrates = 0.5 * 10.0 ** np.arange(-K + 2, 2, dtype=float)
    tmpw = 9.0 * 10.0 ** (-np.arange(1, K + 1, dtype=float))
    w, r = tmpw / tmpw.sum(), inrates[::-1].copy()

    S = cfg.niter // cfg.g
    W = np.empty((S, K))
    R = np.empty((S, K))
    for j in range(1, cfg.niter + 1):
        z = w * r * np.exp(-np.outer(x, r))
        z /= z.sum(axis=1, keepdims=True)
        # categorical indicator per event via inverse CDF
        u = rng.random(len(x))
        s = (u[:, None] > np.cumsum(z, axis=1)).sum(axis=1)
        s = np.minimum(s, K - 1)
        Ns = np.bincount(s, minlength=K).astype(float)
        Ts = np.bincount(s, weights=x, minlength=K)
        w = rng.dirichlet(alpha + Ns)
        r = rng.gamma(a + Ns, 1.0 / (b + Ts))
        if j % cfg.g == 0:
            W[j // cfg.g - 1] = w
            R[j // cfg.g - 1] = r
    return W, R
