"""The plain reference of a tau job, in numpy and plain PyTorch.

Written from basicrta's published algorithm (Sexton et al. 2024, and the
reference package's ``gibbs.py``), not from the program. It takes the
generated event table, never the program's files, except the outputs it
judges.

Three stages, each judged by itself:

- :func:`split_events`: each residue's residence times out of the event
  table. The program's per-residue times must be the same multiset.
- :func:`sample`: the exponential-mixture Gibbs sampler, one categorical
  indicator a event, then the conjugate Dirichlet and Gamma draws. The
  program's chains come from its own device PRNG, so they are judged in
  law: the posterior of the data's log-likelihood under each sample
  (:func:`loglik`), a label-free summary, against this sampler's.
- post-processing, basicrta's ``cluster`` on one chain: post-burn-in
  filtering at the weight cutoff 10 / N and the modal component count
  (:func:`cluster_inputs`); a full-covariance Gaussian mixture fitted by
  EM (k-means starts, the best of ``n_init`` restarts, as scikit-learn's
  ``GaussianMixture``) on the log (weight, rate) pairs of the samples
  with that count (:func:`gmm_labels`); each cluster's membership share
  of every residence time, the expectation of basicrta's indicator
  votes (:func:`membership`); and the slowest non-noise cluster's tau
  with a 95% credible interval (:func:`taus`). :func:`cluster_tau` runs
  them all. The restarts' optima differ at the edges of clusters, so
  the program's labelling is judged by how good a fit it is
  (:func:`fit_quality`) against this fit's, and the tau is worked out
  again from it.
"""

from __future__ import annotations

import numpy as np
import torch


def split_events(resids, durations):
    """{resid: sorted residence times} of an event table."""
    resids = np.asarray(resids)
    order = np.argsort(resids, kind="stable")
    keys = resids[order]
    uniq, starts = np.unique(keys, return_index=True)
    parts = np.split(np.asarray(durations, np.float64)[order], starts[1:])
    return {int(r): np.sort(p) for r, p in zip(uniq, parts)}


def init_state(K):
    """basicrta's start: rates 0.5 * 10^(1 .. -(K-2)) descending, weights a
    normalised ladder 9 * 10^-(1..K)."""
    rates = 0.5 * 10.0 ** np.arange(-K + 2, 2, dtype=np.float64)[::-1]
    w = 9.0 * 10.0 ** (-np.arange(1, K + 1, dtype=np.float64))
    return w / w.sum(), rates.copy()


def sample(times, K, alpha, a, b, sweeps, burnin, thin, seed, device,
           dtype=torch.float32):
    """Run one chain per residue of ``times`` (a list of arrays) together,
    padded to the longest, for ``sweeps`` sweeps; keep every ``thin``-th
    sample after ``burnin``. ``dtype`` is the precision of every step.
    Returns (weights, rates), each (R, S, K) float64 numpy."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    R = len(times)
    N = max(len(t) for t in times)
    t = torch.zeros((R, 1, N), dtype=torch.float64)
    mask = torch.zeros((R, 1, N), dtype=torch.float64)
    for i, x in enumerate(times):
        t[i, 0, :len(x)] = torch.as_tensor(np.asarray(x, np.float64))
        mask[i, 0, :len(x)] = 1.0
    t = t.to(device=device, dtype=dtype)
    mask = mask.to(device=device, dtype=dtype)
    w0, r0 = init_state(K)
    w = torch.as_tensor(np.tile(w0, (R, 1)), dtype=dtype, device=device)
    r = torch.as_tensor(np.tile(r0, (R, 1)), dtype=dtype, device=device)
    comps = torch.arange(K, device=device).view(1, K, 1)
    W, Rt = [], []
    for s in range(1, sweeps + 1):
        logp = (torch.log(w) + torch.log(r))[:, :, None] - r[:, :, None] * t
        p = torch.softmax(logp, dim=1)                      # (R, K, N)
        cdf = torch.cumsum(p, dim=1)
        u = torch.rand((R, 1, N), generator=gen, device=device).to(dtype)
        z = torch.clamp_max((u > cdf).sum(dim=1, keepdim=True), K - 1)
        onehot = (z == comps).to(dtype) * mask               # (R, K, N)
        n = onehot.sum(-1)
        T = (onehot * t).sum(-1)
        g = torch._standard_gamma((alpha + n).float(), generator=gen)
        w = (g / g.sum(-1, keepdim=True)).to(dtype)
        r = (torch._standard_gamma((a + n).float(), generator=gen)
             / (b + T).float()).to(dtype)
        if s > burnin and (s - burnin) % thin == 0:
            W.append(w.double())
            Rt.append(r.double())
    return (torch.stack(W, 1).cpu().numpy(), torch.stack(Rt, 1).cpu().numpy())


def loglik(times, W, R, device="cpu", chunk=64):
    """(S,) log-likelihood of ``times`` under each sample (W, R) (S, K) of
    an exponential mixture, in float64, over unique times."""
    values, counts = np.unique(np.asarray(times, np.float64),
                               return_counts=True)
    v = torch.as_tensor(values, dtype=torch.float64, device=device)
    c = torch.as_tensor(counts, dtype=torch.float64, device=device)
    W = torch.as_tensor(np.asarray(W, np.float64), device=device)
    R = torch.as_tensor(np.asarray(R, np.float64), device=device)
    out = []
    for s0 in range(0, W.shape[0], chunk):
        w, r = W[s0:s0 + chunk], R[s0:s0 + chunk]
        lw = torch.log(w) + torch.log(r)
        lp = torch.logsumexp(lw[:, None, :] - r[:, None, :] * v[None, :, None],
                             dim=-1)                        # (s, V)
        out.append((lp * c).sum(-1))
    return torch.cat(out).cpu().numpy()


def loglik_gap(ll_program, ll_reference):
    """Gap of the program's log-likelihood posterior from the reference's:
    the difference of the medians in units of the reference's spread (its
    interquartile range / 1.349)."""
    q1, q3 = np.percentile(ll_reference, [25, 75])
    sd = max((q3 - q1) / 1.349, 1e-9)
    return abs(float(np.median(ll_program) - np.median(ll_reference))) / sd


# ------------------------------ post-processing ---------------------------- #

def empirical_ci(x, percentage=95.0):
    """basicrta's empirical-CDF interval: lo the largest sorted value with
    CDF <= 2.5%, hi the smallest with CDF >= 97.5%."""
    ds = np.sort(np.asarray(x, np.float64))
    n = ds.size
    perc = np.arange(1, n + 1) / n
    lower = (100.0 - percentage) / 200.0
    upper = (percentage + (100.0 - percentage) / 2.0) / 100.0
    lo_idx = np.where(perc <= lower)[0]
    hi_idx = np.where(perc >= upper)[0]
    lo = ds[lo_idx[-1]] if lo_idx.size else ds[0]
    hi = ds[hi_idx[0]] if hi_idx.size else ds[-1]
    return float(lo), float(hi)


def _log_mode(x, nbins=20):
    """Left edge of the tallest of ``nbins`` log-spaced bins."""
    if x.min() == x.max():
        return float(x.min())
    bins = np.exp(np.linspace(np.log(x.min()), np.log(x.max()), nbins))
    hist, edges = np.histogram(x, bins=bins)
    return float(edges[np.argmax(hist)])


def _gauss2(X, mu, cov):
    """log N(x | mu, cov) of 2-D points: X (N, 2), mu (R, C, 2), cov
    (R, C, 3) as (var x, cov xy, var y) -> (R, N, C)."""
    dx = X[None, :, None, 0] - mu[:, None, :, 0]
    dy = X[None, :, None, 1] - mu[:, None, :, 1]
    a, b, c = (cov[:, None, :, i] for i in range(3))
    det = a * c - b * b
    maha = (c * dx * dx - 2.0 * b * dx * dy + a * dy * dy) / det
    return -0.5 * maha - np.log(2.0 * np.pi) - 0.5 * torch.log(det)


def _m_step(X, resp, reg):
    """Weights, means and covariances of every restart from the
    responsibilities ``resp`` (R, N, C)."""
    nk = resp.sum(1) + 10.0 * torch.finfo(X.dtype).eps       # (R, C)
    mu = torch.einsum("rnc,nd->rcd", resp, X) / nk[..., None]
    dx = X[None, :, None, 0] - mu[:, None, :, 0]
    dy = X[None, :, None, 1] - mu[:, None, :, 1]
    cov = torch.stack([(resp * dx * dx).sum(1) / nk + reg,
                       (resp * dx * dy).sum(1) / nk,
                       (resp * dy * dy).sum(1) / nk + reg], -1)
    return torch.log(nk / X.shape[0]), mu, cov


def _kmeans(X, C, R, gen, max_iter=300):
    """k-means++ seeding, then Lloyd's iterations until no point changes
    its centre: (R, N) labels of ``R`` restarts."""
    N = X.shape[0]
    first = torch.randint(N, (R,), generator=gen, device=X.device)
    centres = [X[first]]
    d2 = ((X[None] - centres[0][:, None]) ** 2).sum(-1)     # (R, N)
    for _ in range(1, C):
        p = d2.float().clamp_min(0)
        p = torch.where(p.sum(-1, keepdim=True) > 0, p, torch.ones_like(p))
        nxt = X[torch.multinomial(p, 1, generator=gen)[:, 0]]
        centres.append(nxt)
        d2 = torch.minimum(d2, ((X[None] - nxt[:, None]) ** 2).sum(-1))
    mu = torch.stack(centres, 1)                             # (R, C, 2)
    labels = None
    for _ in range(max_iter):
        new = ((X[None, :, None] - mu[:, None]) ** 2).sum(-1).argmin(-1)
        if labels is not None and bool((new == labels).all()):
            break
        labels = new
        onehot = torch.nn.functional.one_hot(labels, C).to(X.dtype)
        tot = onehot.sum(1)
        mean = torch.einsum("rnc,nd->rcd", onehot, X) / tot.clamp_min(1)[
            ..., None]
        mu = torch.where(tot[..., None] > 0, mean, mu)
    return labels


def gmm_labels(train, data, C, n_init, max_iter, tol, seed, device,
               dtype=torch.float64, reg=1e-6):
    """Fit a full-covariance Gaussian mixture of ``C`` components to
    ``train`` (M, 2) by EM from ``n_init`` k-means starts at once, keep
    the restart with the best mean log-likelihood, and label ``data``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    X = torch.as_tensor(train, device=device).to(dtype)
    Y = torch.as_tensor(data, device=device).to(dtype)
    resp = torch.nn.functional.one_hot(_kmeans(X, C, n_init, gen), C).to(
        dtype)
    logw, mu, cov = _m_step(X, resp, reg)
    lb = torch.full((n_init,), -float("inf"), dtype=dtype, device=device)
    done = torch.zeros(n_init, dtype=torch.bool, device=device)
    for _ in range(max_iter):
        logp = _gauss2(X, mu, cov) + logw[:, None]
        lse = torch.logsumexp(logp, -1)
        now = lse.mean(-1)
        n_logw, n_mu, n_cov = _m_step(X, torch.exp(logp - lse[..., None]),
                                      reg)
        keep = done[:, None]
        logw = torch.where(keep, logw, n_logw)
        mu = torch.where(keep[..., None], mu, n_mu)
        cov = torch.where(keep[..., None], cov, n_cov)
        settled = ((now - lb).abs() < tol) | torch.isnan(now)
        lb = torch.where(done, lb, now)
        done = done | settled
        if bool(done.all()):
            break
    best = int(torch.argmax(torch.nan_to_num(lb.float(), nan=-np.inf)))
    logp = _gauss2(Y, mu[best:best + 1], cov[best:best + 1])[0] + logw[best]
    return logp.argmax(-1).cpu().numpy()


def membership(W, R, values, L, C, device, dtype=torch.float64, chunk=64):
    """(V, C) share of each cluster in the component of each residence
    time ``values``: the expectation, over the samples (W, R) (S, K)
    with component labels ``L`` (S, K) (-1 below the cutoff), of the
    indicator votes basicrta draws."""
    v = torch.as_tensor(np.asarray(values, np.float64), device=device).to(
        dtype)
    votes = torch.zeros((len(values), C), dtype=dtype, device=device)
    for s0 in range(0, W.shape[0], chunk):
        w = torch.as_tensor(W[s0:s0 + chunk], device=device).to(dtype)
        r = torch.as_tensor(R[s0:s0 + chunk], device=device).to(dtype)
        lab = torch.as_tensor(L[s0:s0 + chunk], device=device)
        logz = (torch.log(w) + torch.log(r))[:, None] - v[None, :, None] * \
            r[:, None]                                        # (s, V, K)
        z = torch.softmax(logz, -1)
        onehot = torch.nn.functional.one_hot(lab + 1, C + 1)[..., 1:].to(
            dtype)                                            # (s, K, C)
        votes += torch.einsum("svk,skc->vc", z, onehot)
    votes = votes.double().cpu().numpy()
    return votes / np.maximum(votes.sum(1, keepdims=True), 1e-300)


def _low(x, dtype):
    """``x`` rounded to ``dtype`` (float64 leaves it as it is)."""
    if dtype == torch.float64:
        return np.asarray(x, np.float64)
    return torch.as_tensor(np.asarray(x, np.float64)).to(dtype).double(
        ).numpy()


def cluster_inputs(W, R, n_events, gibbs):
    """Post-burn-in filtering of one chain's samples W, R (S, K): the
    mask of pairs above the weight cutoff, the modal count C of such
    pairs a sample, the pairs (M, 2) in (sample, component) order, and
    the mask of pairs of the samples with exactly C (the training set)."""
    above = np.asarray(W) > gibbs["weight_cut_events"] / float(n_events)
    lens = above.sum(1)
    C = int(np.bincount(lens).argmax())
    data = np.stack((np.asarray(W)[above], np.asarray(R)[above]), 1)
    return above, C, data, np.repeat(lens == C, lens)


def fit_quality(train, labels, C, device, reg=1e-6):
    """Mean log-likelihood a point of ``train`` (N, 2) under the mixture
    that the hard labelling ``labels`` gives (one M-step), in float64:
    how good a clustering a labelling is, whatever restart found it."""
    X = torch.as_tensor(np.asarray(train, np.float64), device=device)
    lab = torch.as_tensor(np.asarray(labels, np.int64), device=device)
    resp = torch.nn.functional.one_hot(lab, C).to(X.dtype)[None]
    logw, mu, cov = _m_step(X, resp, reg)
    logp = _gauss2(X, mu, cov) + logw[:, None]
    return float(torch.logsumexp(logp, -1).mean())


def taus(W, R, times, above, labels, C, gibbs, device,
         dtype=torch.float64, doubt=0.0):
    """Every (lo, tau, hi) of the slowest non-noise cluster that the
    labelling ``labels`` of the pairs ``above`` admits: a cluster is
    noise where its largest membership share of a residence time is under
    the noise cutoff, and one within ``doubt`` of the cutoff may go
    either way (the program draws its votes; their shares scatter about
    the expectation this works out). (0, 0, 0) where every cluster is
    noise. Every step in ``dtype``."""
    data = np.stack((W[above], R[above]), 1)
    L = np.full(W.shape, -1, np.int64)
    L[above] = labels
    imax = membership(W, R, np.unique(times), L, C, device, dtype).max(0)
    cut = gibbs["noise_cutoff"]
    modes = {c: _log_mode(data[labels == c, 1]) for c in range(C)
             if (labels == c).any()}
    modes = {c: m for c, m in modes.items() if np.isfinite(m)}
    sure = [c for c in modes if imax[c] >= cut + doubt]
    open_ = [c for c in modes if abs(imax[c] - cut) < doubt][:4]
    out = set()
    for pick in range(2 ** len(open_)):
        ok = sure + [c for i, c in enumerate(open_) if pick >> i & 1]
        if not ok:
            out.add((0.0, 0.0, 0.0))
            continue
        slowest = min(ok, key=modes.get)
        x = _low(1.0 / _low(data[labels == slowest, 1], dtype), dtype)
        lo, hi = empirical_ci(x)
        hist, edges = np.histogram(x, bins=15)
        i = int(np.argmax(hist))
        out.add((lo, float(_low(0.5 * (edges[i] + edges[i + 1]), dtype)),
                 hi))
    return sorted(out)


def cluster_tau(W, R, times, gibbs, seed, device, dtype=torch.float64):
    """basicrta's ``cluster`` of one chain's post-burn-in samples W, R
    (S, K) of ``times``, every step in ``dtype``: (labels of the pairs
    above the cutoff, (lo, tau, hi))."""
    W, R = _low(W, dtype), _low(R, dtype)
    above, C, data, train = cluster_inputs(W, R, len(times), gibbs)
    labels = gmm_labels(np.log(data[train]), np.log(data), C,
                        gibbs["gmm_n_init"], gibbs["gmm_max_iter"],
                        gibbs["gmm_tol"], seed, device, dtype)
    return labels, taus(W, R, times, above, labels, C, gibbs, device,
                        dtype)[0]


def rel_gap(a, b):
    """Largest relative gap of two (lo, tau, hi) triples."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))
