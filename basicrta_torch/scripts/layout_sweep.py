"""Measured sweep of lane-layout endpoints on the card.

Port of the JAX package's ``scripts/layout_sweep.py``: lays the protein
workload (``basicrta_torch.scripts.workload.bench_residues``) out five ways,
prints each layout's modelled cost (the TPU-fitted ``_COST_*`` of
``basicrta_torch.sampler.batch``) and measures each, interleaved across
reps, so the model's ranking can be held against the card's.

Variants:
  dp_mixed    the production default (the cost-model DP + k-way mixed
              packing)
  dp_uniform  the DP with the uniform split only (no mixed pass)
  ext_classes the DP over its config classes plus multi-row 16/32-column
              segments (pack 8/4 at any V)
  greedy      the raw fine ladder (consolidate=False)
  pow2        the coarse power-of-two unpacked ladder

A rep of a variant is one ``run_batch(defer_transfer=True)`` a bucket,
then ``finalize_batch`` of each: every bucket is launched before any
result is copied to the host. Its time is the host's clock around the
whole, which the copies synchronize.

Usage:
    python -m basicrta_torch.scripts.layout_sweep [--reps 3]
        [--sweeps 10000] [--variants dp_mixed,...] [--device cpu]
"""

import argparse
import time

import numpy as np

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch as bt
from basicrta_torch.sampler.batch import (bucket_residues, finalize_batch,
                                          run_batch)
from basicrta_torch.sampler.kernels import SMALL_NMAX

VARIANTS = ("dp_mixed", "dp_uniform", "ext_classes", "greedy", "pow2")

_ORIG_CFGS = bt._dp_configs


def ext_configs(Vm):
    """_dp_configs plus multi-row sub-width segment classes."""
    out = _ORIG_CFGS(Vm)
    for w in (16, 32):
        width = w * -(-Vm // w)
        if (width, 128 // w) not in out:
            out.append((width, 128 // w))
    return out


def make_batches(residues, variant):
    if variant == "dp_mixed":
        return bucket_residues(residues)
    if variant == "dp_uniform":
        return bucket_residues(residues, mixed_pack=False)
    if variant == "ext_classes":
        # bucket_residues finds _dp_configs through the module global
        bt._dp_configs = ext_configs
        try:
            return bucket_residues(residues)
        finally:
            bt._dp_configs = _ORIG_CFGS
    if variant == "greedy":
        return bucket_residues(residues, consolidate=False)
    if variant == "pow2":
        return bucket_residues(residues, ladder="pow2")
    raise ValueError(variant)


def modeled_cost(batches):
    """The layout's modelled µs a sweep: the sum of its buckets'."""
    tot = 0.0
    for b in batches:
        if b.bounds is not None:
            tot += bt._mixed_cost([(None, None, c) for c in b.counts],
                                  b.bounds, b.phys_rows)
        else:
            he = int(max(np.sum(c > SMALL_NMAX) for c in b.counts))
            s1 = int(max(np.sum(c > 1) for c in b.counts))
            tot += bt._layout_cost(b.size, b.values.shape[1], b.pack,
                                   he, s1)
    return tot


def run_layout(batches, cfg, engine, device):
    """One rep: every bucket launched, then every result copied; returns
    the wall seconds."""
    t0 = time.perf_counter()
    outs = [run_batch(b, cfg, engine=engine, device=device,
                      defer_transfer=True) for b in batches]
    for o in outs:
        finalize_batch(o)
    return time.perf_counter() - t0


def sweep(residues, variants, sweeps, reps, device, out=print):
    """{variant: (modelled µs a sweep, [rep seconds])}."""
    from basicrta_torch.sampler.batch import resolve_engine
    engine, device = resolve_engine(None, device)
    cfg = GibbsConfig(ncomp=15, niter=sweeps, g=100)
    total_lanes = len(residues)
    layouts = {}
    for v in variants:
        t0 = time.perf_counter()
        batches = make_batches(residues, v)
        model = modeled_cost(batches)
        layouts[v] = (model, batches)
        out(f"{v}: model {model:7.1f} us/sweep, "
            f"waste {bt.modeled_work_waste(batches):.3f}, layout "
            f"{time.perf_counter() - t0:.2f} s (host), "
            f"{[(b.size, b.values.shape[1], b.pack) for b in batches]}")
        run_layout(batches, cfg, engine, device)       # warm
    times = {v: [] for v in variants}
    for rep in range(reps):
        for v in variants:
            dt = run_layout(layouts[v][1], cfg, engine, device)
            times[v].append(dt)
            out(f"rep {rep} {v:12s} "
                f"{total_lanes * cfg.niter / dt:12,.0f} sweeps/s")
    return {v: (layouts[v][0], times[v]) for v in variants}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweeps", type=int, default=10_000)
    ap.add_argument("--variants", type=str, default=",".join(VARIANTS))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (K2/K3, the default; raises without "
                         "one) or the CPU (their plain versions)")
    args = ap.parse_args(argv)

    from basicrta_torch.sampler.batch import resolve_engine
    from basicrta_torch.scripts.workload import bench_residues
    resolve_engine(None, args.device)     # the card unless asked
    residues = bench_residues()
    res = sweep(residues, args.variants.split(","), args.sweeps, args.reps,
                args.device, out=lambda s: print(s, flush=True))
    print("\n== medians ==")
    meds = {v: float(np.median(ts)) for v, (_, ts) in res.items()}
    best = min(meds.values())
    for v, m in sorted(meds.items(), key=lambda kv: kv[1]):
        agg = len(residues) * args.sweeps / m
        print(f"{v:12s} {agg:12,.0f} sweeps/s  "
              f"({m / best - 1.0:+.1%} vs best)  model "
              f"{res[v][0]:7.1f} us/sweep")
    return res


if __name__ == "__main__":
    main()
