"""Refit the layout DP's per-bucket cost model on the card.

Port of the JAX package's ``scripts/calibrate_layout.py``. The
coefficients in ``basicrta_torch.sampler.batch`` (``_COST_PER_BUCKET``
etc., fitted on the TPU and carried over unchanged) price a bucket's
per-sweep time from its physical layout; the DP and the mixed-width packer
arbitrate layouts with them. This script measures what they should be
for the sweep kernels on the card, and prints the refit beside the
current constants. It changes no constant: a new default waits for a
benchmark that shows the layout it picks is faster end to end.

Method: lay the 300-residue protein workload
(``basicrta_torch.scripts.workload.bench_residues``) out under several
layouts (mixed kmax2..12, uniform, pow2, greedy), time EVERY distinct
bucket at two sweep depths with CUDA events around the launch of
``cuda_sweep.segment`` (K2) or ``segment_packed`` (K3), the layouts
interleaved across reps, and take the per-sweep cost as the slope
(T(S2) - T(S1)) / (S2 - S1), which cancels the launch's fixed cost. Then
fit, non-negative least squares,

    T_sweep = c_bucket * NG + c_row * lanes * SL
              + c_head * lanes * head + c_small * lanes * (small - head)
              + c_lane * lanes * pack

with the JAX package's features (``_phys_groups``: the TPU's 64-lane
groups), so ``--fit-only`` on the same rows gives the JAX script's
coefficients, and print R^2 and each bucket's residual. Buckets are timed
one after another, as the JAX script does; in production
(``run_residues``) every bucket runs at once, a CUDA stream each, so the
fit prices a bucket alone.

Usage:
    python -m basicrta_torch.scripts.calibrate_layout [--reps 3]
        [--s1 2000] [--s2 8000] [--layouts mixed,kmax2,...]
        [--json out.json] [--fit-only] [--device cpu]
"""

import argparse
import json
import sys
import time

import numpy as np

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch as bt
from basicrta_torch.sampler.batch import bucket_residues
from basicrta_torch.sampler.kernels import MixtureState, init_mixture_params

COEF_NAMES = ["_COST_PER_BUCKET", "_COST_ROW", "_COST_HEAD_PREM",
              "_COST_SMALL_PREM", "_COST_LANE_LOG"]


def _layout_batches(residues, lay):
    if lay == "uniform":
        return bucket_residues(residues, mixed_pack=False)
    if lay == "pow2":
        return bucket_residues(residues, ladder="pow2", mixed_pack=False)
    if lay == "greedy":
        return bucket_residues(residues, consolidate=False)
    if lay.startswith("kmax"):
        return bucket_residues(residues, kmax=int(lay[4:]))
    return bucket_residues(residues)


def _bucket_geometry(b):
    """Physical layout parameters the cost model charges: (Bph, SL, head,
    small, pack)."""
    from basicrta_torch.sampler.batch import _mixed_row_tiers, _pack_mixed
    from basicrta_torch.sampler.cuda_sweep import (packed_row_tiers,
                                                   pad_tiers_to_rows)
    if b.bounds is not None:
        Bph = len(b.bounds)
        _, c_ph, _, _ = _pack_mixed(
            np.asarray(b.values, np.float32),
            np.asarray(b.counts, np.float32), b.bounds, b.phys_rows)
        head, small = _mixed_row_tiers(c_ph)
        return Bph, b.phys_rows, head, small, b.pack
    if b.pack > 1:
        seg_w = 128 // b.pack
        SL = b.values.shape[1] // seg_w
        head, small = packed_row_tiers(b.tiers, seg_w, SL)
        # physical lanes as run_batch pads them (a partial last lane)
        return -(-b.size // b.pack), SL, head, small, b.pack
    SL = max(b.values.shape[1] // 128, 1)
    head, small = pad_tiers_to_rows(b.tiers, b.values.shape[1])
    return b.size, SL, head, small, 1


def _make_run(b, cfg, n_blocks, device):
    """A closure that launches ``n_blocks`` thinning blocks of bucket
    ``b`` in one call from the initial state, laid out as ``run_batch``
    lays it (``batch._kernel_layout``: ``_pack_mixed`` and
    ``_mixed_row_tiers`` for mixed buckets, ``packed_row_tiers`` or
    ``pad_tiers_to_rows`` for the others), and returns the call's
    milliseconds: CUDA events around the launch on the card (K2 or K3),
    the host's clock around the plain version on the CPU."""
    import torch

    from basicrta_torch.sampler import cuda_sweep as cs
    values, counts, tiers, seg_id, _, Bs = bt._kernel_layout(b)
    on_card = device.type == "cuda"
    values, counts = (torch.as_tensor(x, dtype=torch.float32, device=device)
                      for x in (values, counts))
    seg_mask = None if seg_id is None else torch.as_tensor(seg_id,
                                                            device=device)
    st0 = init_mixture_params(cfg.ncomp)
    state = MixtureState(st0.weights.repeat(Bs, 1).to(device),
                         st0.rates.repeat(Bs, 1).to(device))
    if b.pack > 1:
        fn = cs.segment_packed if on_card else cs.segment_packed_torch

        def launch():
            return fn(7, 0, state, values, counts, cfg, n_blocks, tiers,
                      b.pack, seg_mask)
    else:
        fn = cs.segment if on_card else cs.segment_torch

        def launch():
            return fn(7, 0, state, values, counts, cfg, n_blocks, tiers)

    def go():
        if not on_card:
            t0 = time.perf_counter()
            launch()
            return (time.perf_counter() - t0) * 1e3
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    return go


def measure(residues, layouts, s1, s2, reps, device, log=None, g=100):
    """Rows {layout, bucket, Bph, SL, head, small, pack, us_per_sweep} of
    every distinct bucket of each layout: the slope between the best of
    ``reps`` timed calls at ``s1`` and at ``s2`` sweeps (multiples of the
    thinning interval ``g``), after one warm call each; the layouts
    interleave within every rep. Progress goes to ``log`` (default
    standard error)."""
    log = log or sys.stderr
    runs = {}    # (layout, bucket, S) -> (go, geometry)
    for lay in layouts:
        batches = _layout_batches(residues, lay)
        for bi, b in enumerate(batches):
            geom = _bucket_geometry(b)
            for S in (s1, s2):
                cfg = GibbsConfig(ncomp=15, niter=S, g=g)
                runs[(lay, bi, S)] = (_make_run(b, cfg, S // g, device),
                                      geom)
        print(f"[{lay}] {[_bucket_geometry(b) for b in batches]}",
              file=log, flush=True)
    for key, (go, _) in runs.items():
        print(f"warm {key}: {go():.1f} ms", file=log, flush=True)
    times = {k: [] for k in runs}
    for _ in range(reps):
        for key, (go, _) in runs.items():
            times[key].append(go())
    rows = []
    for lay, bi, S in runs:
        if S != s1:
            continue
        geom = runs[(lay, bi, s1)][1]
        slope = ((min(times[(lay, bi, s2)]) - min(times[(lay, bi, s1)]))
                 / (s2 - s1) * 1e3)                     # us a sweep
        rows.append({"layout": lay, "bucket": bi, "Bph": geom[0],
                     "SL": geom[1], "head": geom[2], "small": geom[3],
                     "pack": geom[4], "us_per_sweep": slope})
    return rows


def fit(rows):
    """(coefficients, R^2, predictions) of the NNLS fit of
    ``us_per_sweep`` on the five cost terms."""
    from scipy.optimize import nnls
    A, y = [], []
    for r in rows:
        NG, G = bt._phys_groups(r["Bph"], r["SL"], r["pack"])
        lanes = NG * G
        A.append([NG, lanes * r["SL"], lanes * r["head"],
                  lanes * (r["small"] - r["head"]), lanes * r["pack"]])
        y.append(r["us_per_sweep"])
    A, y = np.asarray(A), np.asarray(y)
    # nonnegative least squares: the terms are physical costs, and the
    # plain lstsq goes unphysical (a negative per-bucket constant) when
    # the sampled shapes leave features collinear
    coef, _ = nnls(A, y)
    pred = A @ coef
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return coef, 1 - ss_res / ss_tot, pred


def report(rows, out=None):
    """Print the refit beside the current constants, R^2 and every
    bucket's measured against modelled µs a sweep (to ``out``, default
    standard output); returns (coefficients, R^2)."""
    out = out or sys.stdout
    coef, r2, pred = fit(rows)
    cur = [getattr(bt, n) for n in COEF_NAMES]
    print(f"\n{len(rows)} bucket timings, R^2 = {r2:.3f}", file=out)
    print(f"{'coef':18s} {'current':>9s} {'refit':>9s}", file=out)
    for n, c, f in zip(COEF_NAMES, cur, coef):
        print(f"{n:18s} {c:9.3f} {f:9.3f}", file=out)
    print("\nper-bucket (us/sweep): measured vs model", file=out)
    for r, p in zip(rows, pred):
        print(f"  {r['layout']:8s} b{r['bucket']} Bph={r['Bph']:<4d} "
              f"SL={r['SL']:<3d} h={r['head']} s={r['small']} "
              f"p={r['pack']:<2d}: {r['us_per_sweep']:7.1f} vs {p:7.1f}",
              file=out)
    return coef, r2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--s1", type=int, default=2000)
    ap.add_argument("--s2", type=int, default=8000)
    ap.add_argument("--residues", type=int, default=300)
    ap.add_argument("--layouts",
                    default="mixed,kmax2,kmax4,kmax8,uniform,pow2,greedy")
    ap.add_argument("--json", default="calibration.json")
    ap.add_argument("--fit-only", action="store_true",
                    help="skip measurement; refit from --json (several "
                         "files comma-separated)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the buckets run: the card (K2/K3, the "
                         "default; raises without one) or the CPU (their "
                         "plain versions)")
    args = ap.parse_args(argv)

    rows = []
    if args.fit_only:
        for p in args.json.split(","):
            with open(p) as f:
                rows.extend(json.load(f))
    else:
        from basicrta_torch.sampler.batch import resolve_engine
        from basicrta_torch.scripts.workload import bench_residues
        _, device = resolve_engine(None, args.device)
        rows = measure(bench_residues(args.residues),
                       args.layouts.split(","), args.s1, args.s2,
                       args.reps, device)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return report(rows)


if __name__ == "__main__":
    main()
