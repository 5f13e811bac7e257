"""Statistical validation of the port against the reference algorithm.

Port of the JAX package's ``scripts/validate.py``; three parts:

1. FULL RUN: the default-configuration posterior (K = 15, 110,000
   sweeps, thinning 100, burn-in 10,000) on the whole dataset through
   ``Gibbs``, with tau of the slowest process and its 95% CI.
2. CROSS-CHECK: on a random subsample (tractable for a per-event numpy
   sampler), the engine's posterior against the independent numpy
   implementation of the reference's per-event sweep
   (``scripts/reference_sampler.py``): KS tests on the dominant
   component's weight and rate samples and the slowest-process tau CIs.
3. FULL PROTEIN: 50 synthetic residues at the default configuration
   through ``run_residues`` and the batched post-processing.

    python -m basicrta_torch.scripts.validate [times.npy]
        [--subsample 40000] [--sub-niter 10000] [--protein-residues 50]
        [--engine cuda|torch|collapsed] [--device cuda|cpu]

Without a ``times.npy`` the dataset is ``datafiles.synthetic_times()``
(446,605 W313-scale events).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
from scipy import stats

from basicrta_torch.config import GibbsConfig
from basicrta_torch.datafiles import synthetic_times
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.protein.driver import finish_batch
from basicrta_torch.sampler.batch import (bucket_residues, resolve_engine,
                                          run_batch, run_residues)
from basicrta_torch.sampler.gibbs import Gibbs
from basicrta_torch.scripts.reference_sampler import numpy_reference_sampler


def dominant(W, R, burn):
    """Post-burn-in (weights, rates) samples of the heaviest component."""
    Wp, Rp = W[burn:], R[burn:]
    k = Wp.mean(axis=0).argmax()
    return Wp[:, k], Rp[:, k]


def slow_taus(W, R, burn, wcut):
    """Post-burn-in 1/rate samples of the slowest live component."""
    Wp, Rp = W[burn:], R[burn:]
    live = Wp.mean(0) > wcut
    k = np.where(live)[0][Rp.mean(0)[live].argmin()]
    return 1.0 / Rp[:, k]


def cross_check(x, cfg, engine=None, device=None, ref_seed=1):
    """The numpy reference sampler and ``engine`` on the same data:
    {'ref': (W, R), 'ours': (W, R), 't_ref': s, 't_ours': s}, each (S, K)
    of one chain."""
    t0 = time.time()
    Wn, Rn = numpy_reference_sampler(x, cfg, seed=ref_seed)
    t_ref = time.time() - t0
    t0 = time.time()
    res = run_batch(bucket_residues({"R": x})[0], cfg, engine=engine,
                    device=device)
    return {"ref": (Wn, Rn), "ours": (res.mcweights[0], res.mcrates[0]),
            "t_ref": t_ref, "t_ours": time.time() - t0}


def protein_times(n_res, seed=1):
    """The full-protein part's residues: sizes log-uniform in
    10^2..10^5.3 events, W313-shaped mixtures with rates scaled by
    U(0.7, 1.5), on the 0.1 ns grid."""
    rng = np.random.default_rng(seed)
    sizes = (10 ** rng.uniform(2.0, 5.3, n_res)).astype(int)
    return {f"X{i}": discretize_times(simulate_hyperexp(
        int(n), [0.87, 0.09, 0.03, 0.009, 0.001],
        np.array([4.7, 1.3, 0.33, 0.06, 0.009]) * rng.uniform(0.7, 1.5),
        rng), 0.1) for i, n in enumerate(sizes)}


def full_protein(times, cfg, n_chains=1, engine=None, device=None):
    """Sample every residue (``run_residues``) and post-process them in
    batches (``finish_batch``). Returns ({label: Gibbs}, sampling seconds,
    post-processing seconds)."""
    engine, device = resolve_engine(engine, device)
    t0 = time.time()
    samples = run_residues(times, cfg, n_chains=n_chains, engine=engine,
                           device=device)
    t_samp = time.time() - t0
    gibbs = {}
    for lab, (W, R) in samples.items():
        g = Gibbs(times[lab], residue=lab, cutoff=7.0, cfg=cfg)
        g.mcweights, g.mcrates = W, R
        gibbs[lab] = g
    t0 = time.time()
    finish_batch(gibbs, save=False, device=device)
    return gibbs, t_samp, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("times", nargs="?", default=None,
                    help="residence times (.npy); default the synthetic "
                         "W313-scale dataset")
    ap.add_argument("--subsample", type=int, default=40_000)
    ap.add_argument("--sub-niter", type=int, default=10_000)
    ap.add_argument("--protein-residues", type=int, default=50,
                    help="residue count of the full-protein post-processing "
                         "throughput check (0 disables)")
    ap.add_argument("--engine", choices=["cuda", "torch", "collapsed"],
                    default=None, help="sweep engine (default cuda)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the engine runs (default the card; the CPU "
                         "for --engine torch)")
    args = ap.parse_args(argv)
    engine, device = resolve_engine(args.engine, args.device)

    x = synthetic_times() if args.times is None else np.load(args.times)
    print(f"dataset: N={len(x)}, range [{x.min()}, {x.max()}] ns")

    # ---- 1. full default-config run through the product pipeline ------- #
    cfg = GibbsConfig()  # ncomp=15, niter=110000, g=100, burnin=10000
    g = Gibbs(x, residue="W313", cutoff=7.0, cfg=cfg)
    t0 = time.time()
    g.run(engine=engine, device=device, save=False)
    wall = time.time() - t0
    t0 = time.time()
    g.process_gibbs(save=False)
    lo, mode, hi = g.estimate_tau()
    t_post = time.time() - t0
    print(f"FULL RUN ({cfg.niter} sweeps, K={cfg.ncomp}): sampling "
          f"{wall:.1f}s ({cfg.niter / wall:,.0f} sweeps/s), "
          f"post-processing {t_post:.1f}s")
    print(f"  slowest-process tau = {mode:.1f} ns, 95% CI "
          f"[{lo:.1f}, {hi:.1f}]  (lmode={g.processed.lmode})")

    # ---- 2. subsample cross-check vs reference semantics --------------- #
    rng = np.random.default_rng(0)
    sub = rng.choice(x, size=min(args.subsample, len(x)), replace=False)
    cfg2 = GibbsConfig(ncomp=10, niter=args.sub_niter, g=10,
                       burnin=args.sub_niter // 5, seed=3)
    cc = cross_check(sub, cfg2, engine, device)
    b2 = cfg2.burnin_samples
    w_ref, r_ref = dominant(*cc["ref"], b2)
    w_our, r_our = dominant(*cc["ours"], b2)
    ks_w = stats.ks_2samp(w_ref, w_our)
    ks_r = stats.ks_2samp(r_ref, r_our)
    wcut2 = cfg2.wcutoff(len(sub))
    ci_ref = np.percentile(slow_taus(*cc["ref"], b2, wcut2), [2.5, 97.5])
    ci_our = np.percentile(slow_taus(*cc["ours"], b2, wcut2), [2.5, 97.5])
    print(f"CROSS-CHECK (N={len(sub)}, {cfg2.niter} sweeps): "
          f"numpy-reference {cc['t_ref']:.0f}s vs framework "
          f"{cc['t_ours']:.1f}s "
          f"({cc['t_ref'] / max(cc['t_ours'], 1e-9):,.0f}x)")
    print(f"  dominant weight: ref {w_ref.mean():.4f} vs ours "
          f"{w_our.mean():.4f} (KS p={ks_w.pvalue:.3f})")
    print(f"  dominant rate:   ref {r_ref.mean():.4f} vs ours "
          f"{r_our.mean():.4f} (KS p={ks_r.pvalue:.3f})")
    print(f"  slowest tau CI:  ref [{ci_ref[0]:.1f}, {ci_ref[1]:.1f}] vs "
          f"ours [{ci_our[0]:.1f}, {ci_our[1]:.1f}]")

    # ---- 3. full-protein post-processing throughput --------------------- #
    # batched post-processing must stay within ~2x of sampling wall-clock
    n_res = args.protein_residues
    if n_res:
        cfg3 = GibbsConfig()  # full default config
        gibbs, t_samp, t_fin = full_protein(protein_times(n_res), cfg3,
                                            engine=engine,
                                            device=device)
        # a second pass over the same residues: the steady-state cost
        t0 = time.time()
        finish_batch(gibbs, save=False, device=device)
        t_fin2 = time.time() - t0
        n_ok = sum(1 for g_ in gibbs.values() if g_.tau is not None)
        print(f"FULL PROTEIN ({n_res} residues, {cfg3.niter} sweeps): "
              f"sampling {t_samp:.1f}s, post-processing {t_fin:.1f}s cold / "
              f"{t_fin2:.1f}s warm ({t_fin2 / t_samp:.2f}x sampling; "
              f"{n_ok}/{n_res} taus)")
    return 0


if __name__ == "__main__":
    main()
