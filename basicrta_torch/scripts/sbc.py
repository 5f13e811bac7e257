"""Simulation-based calibration of the Gibbs sampler.

Port of the JAX package's ``scripts/sbc.py``. SBC (Talts et al. 2018):
draw parameters from the model prior, simulate a dataset from them,
sample the posterior, and record the rank of the true parameter among the
posterior draws. If the sampler targets the correct posterior, ranks are
uniform over {0..S} across replicates: a whole-posterior check, far
stronger than point-estimate recovery, and the check in law of the fused
kernels against the model.

Mixture labels are not identifiable (label switching), so ranks are taken
on identifiable functionals of the parameters: the mean residence time
E[x] = sum_k w_k / r_k and survival probabilities S(t) = sum_k w_k
exp(-r_k t) at several t. Every replicate dataset is one lane of a
bucket, so M replicates cost about one residue's time.

    python -m basicrta_torch.scripts.sbc [--replicates 64] [--events 2000]
        [--niter 20000] [--ncomp 5] [--engine cuda|torch|collapsed]
        [--device cuda|cpu] [--mixed-sizes] [--seed 0]

Prints per-functional chi-square uniformity p-values; p > 0.01 for all
functionals passes (exit code 0).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
from scipy import stats

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler.batch import (bucket_residues, resolve_engine,
                                          run_batch)

TS_PROBE = (0.5, 2.0, 10.0)
RANK_BINS = 8


def functionals(w, r, ts_probe=TS_PROBE):
    """Identifiable functionals of mixture params; w/r (..., K)."""
    mean = np.sum(w / r, axis=-1)
    surv = [np.sum(w * np.exp(-r * t), axis=-1) for t in ts_probe]
    return np.stack([mean] + surv, axis=-1)   # (..., 1+T)


def run_sbc(M=64, n_events=2000, ncomp=5, niter=20_000, g=100,
            burnin=4000, seed=0, engine=None, device=None, progress=print,
            mixed_sizes=False):
    """Ranks of the true functionals among M replicates' posteriors on
    ``engine`` (see ``resolve_engine``). Returns ({functional: chi-square
    p-value}, (M, F) ranks). ``mixed_sizes`` draws replicate sizes
    log-uniform in [n_events / 4, n_events], which forces the
    mixed-width packed layout (K3 on the 'cuda' engine)."""
    engine, device = resolve_engine(engine, device)
    rng = np.random.default_rng(seed)
    cfg = GibbsConfig(ncomp=ncomp, niter=niter, g=g, burnin=burnin,
                      seed=seed + 1)

    # prior draws (the sampler's own prior: Dirichlet(alpha), Gamma(a, b))
    w_true = rng.dirichlet(np.full(ncomp, cfg.alpha_eff), M)
    r_true = rng.gamma(cfg.gamma_shape, 1.0 / cfg.gamma_rate, (M, ncomp))
    datasets = {}
    for m in range(M):
        n_m = n_events
        if mixed_sizes:
            n_m = int(10 ** rng.uniform(np.log10(n_events / 4),
                                        np.log10(n_events)))
        comp = rng.choice(ncomp, n_m, p=w_true[m])
        datasets[f"S{m}"] = rng.exponential(1.0 / r_true[m][comp])

    # all replicates as lanes (continuous times: every value unique, the
    # collapsed formulation degrades gracefully)
    batches = bucket_residues(datasets)
    if mixed_sizes:
        n_mixed = sum(b.bounds is not None for b in batches)
        progress(f"SBC layout: {len(batches)} buckets, {n_mixed} mixed")
    names, W, R = [], [], []
    for b in batches:
        res = run_batch(b, cfg, engine=engine, device=device)
        names += res.names
        W.append(res.mcweights)
        R.append(res.mcrates)
    W = np.concatenate(W, axis=0)    # (M, S, K)
    R = np.concatenate(R, axis=0)
    order = np.argsort([int(n[1:]) for n in names])
    W, R = W[order], R[order]

    b = cfg.burnin_samples
    post = functionals(W[:, b:], R[:, b:])       # (M, S', F)
    true = functionals(w_true, r_true)           # (M, F)
    S = post.shape[1]
    ranks = np.sum(post < true[:, None, :], axis=1)    # (M, F) in 0..S

    # chi-square uniformity per functional, ranks binned to RANK_BINS cells
    labels = ["mean"] + [f"S({t})" for t in TS_PROBE]
    pvals = {}
    for f, lab in enumerate(labels):
        binned = np.bincount(np.minimum(ranks[:, f] * RANK_BINS // (S + 1),
                                        RANK_BINS - 1), minlength=RANK_BINS)
        expected = M / RANK_BINS
        chi2 = np.sum((binned - expected) ** 2 / expected)
        pvals[lab] = float(stats.chi2.sf(chi2, RANK_BINS - 1))
        progress(f"SBC {lab:8s}: ranks {binned.tolist()}  "
                 f"chi2 p={pvals[lab]:.3f}")
    return pvals, ranks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicates", type=int, default=64)
    ap.add_argument("--events", type=int, default=2000)
    ap.add_argument("--ncomp", type=int, default=5)
    ap.add_argument("--niter", type=int, default=20_000)
    ap.add_argument("--engine", choices=["cuda", "torch", "collapsed"],
                    default=None, help="sweep engine (default cuda)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the engine runs (default the card; the CPU "
                         "for --engine torch)")
    ap.add_argument("--mixed-sizes", action="store_true",
                    help="heterogeneous replicate sizes: calibrates the "
                         "mixed-width packed kernel path")
    ap.add_argument("--seed", type=int, default=0,
                    help="prior/data/sampler seed: a borderline fixed-"
                         "seed p-value is one random instance — check "
                         "uniformity ACROSS seeds before reading it as "
                         "miscalibration")
    args = ap.parse_args(argv)
    pvals, _ = run_sbc(M=args.replicates, n_events=args.events,
                       ncomp=args.ncomp, niter=args.niter, seed=args.seed,
                       engine=args.engine, device=args.device,
                       mixed_sizes=args.mixed_sizes)
    ok = all(p > 0.01 for p in pvals.values())
    print("SBC:", "PASS" if ok else "FAIL", pvals)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
