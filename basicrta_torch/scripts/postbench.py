"""Warm post-processing time, split by stage, on the card.

Port of the JAX package's ``scripts/postbench.py``: times
``process_residues_batched`` on the 64-residue live workload (the first 64
residues of bench.py's protein, sampled 10,000 sweeps on the production
layout), split into its stages through the ``timings`` hook (host prep,
GMM buckets, vote buckets, host finish), best of ``--reps`` warm calls.
It also checks that the outputs with ``timings={}`` are bitwise those
without: the hook synchronizes the device at stage ends and must change
nothing else.

Usage:
    python -m basicrta_torch.scripts.postbench [--reps 3] [--residues 64]
        [--device cpu]
"""

import argparse
import time

import numpy as np

from basicrta_torch.config import GibbsConfig
from basicrta_torch.postprocess.batched import process_residues_batched
from basicrta_torch.sampler.batch import (bucket_residues, resolve_engine,
                                          run_batch)

TIMED_SWEEPS = 10_000     # bench.py's TIMED_SWEEPS
_FIELDS = ("labels", "data", "pindicator_values", "presorts")


def make_items(n_residues, device):
    """The residue subset bench.py's post-processing time uses: the first
    ``n_residues`` of the protein, sampled ``TIMED_SWEEPS`` sweeps in
    whichever production bucket they land in, with their live values and
    counts."""
    from basicrta_torch.scripts.workload import bench_residues
    cfg = GibbsConfig(ncomp=15, niter=TIMED_SWEEPS, g=100)
    residues = bench_residues()
    sub_names = set(list(residues)[:n_residues])
    items = {}
    for b in bucket_residues(residues):
        picked = [i for i, n in enumerate(b.names) if n in sub_names]
        if not picked:
            continue
        res = run_batch(b, cfg, device=device)
        for i in picked:
            live = b.counts[i] > 0
            items[b.names[i]] = (res.mcweights[i][None],
                                 res.mcrates[i][None],
                                 b.values[i][live], b.counts[i][live])
    return items, cfg


def same_results(a, b) -> bool:
    """Every residue's ClusterResult bitwise equal."""
    if a.keys() != b.keys():
        return False
    for name in a:
        if a[name].lmode != b[name].lmode or any(
                not np.array_equal(getattr(a[name], f),
                                   getattr(b[name], f))
                for f in _FIELDS):
            return False
        if any(not np.array_equal(x, y)
               for x, y in zip(a[name].inds, b[name].inds)):
            return False
    return True


def bench(items, pcfg, reps, device):
    """(best warm total seconds, its stage split, outputs bitwise equal
    with and without ``timings``)."""
    plain = process_residues_batched(items, pcfg, device=device)   # cold
    stages, best_total, same = {}, np.inf, True
    for _ in range(reps):
        t = {}
        t0 = time.perf_counter()
        out = process_residues_batched(items, pcfg, device=device,
                                       timings=t)
        total = time.perf_counter() - t0
        same = same and same_results(plain, out)
        if total < best_total:
            best_total, stages = total, t
    return best_total, stages, same


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--residues", type=int, default=64)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (the default; raises without one) or "
                         "the CPU")
    args = ap.parse_args(argv)

    _, device = resolve_engine(None, args.device)
    items, cfg = make_items(args.residues, device)
    pcfg = GibbsConfig(ncomp=15, niter=cfg.niter, g=100,
                       burnin=cfg.niter // 10)
    best_total, stages, same = bench(items, pcfg, args.reps, device)
    n = len(items)
    print(f"\n{n} residues, warm total {best_total:.3f} s "
          f"({best_total / n * 1e3:.1f} ms/residue)")
    for k, v in stages.items():
        print(f"  {k:12s} {v:7.3f} s  ({v / n * 1e3:5.1f} ms/residue)")
    print(f"outputs with timings bitwise those without: {same}")
    if not same:
        raise SystemExit("the timings hook changed the outputs")
    return best_total, stages


if __name__ == "__main__":
    main()
