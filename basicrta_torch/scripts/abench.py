"""Interleaved A/B timing of the sweep kernels' variants on the card.

Counterpart of ``scripts/abench.py``: times ``segment`` / ``segment_packed``
directly, per bucket of the 300-residue benchmark workload
(``basicrta_torch.scripts.workload``), with the variants interleaved across
reps so that drift between them cancels. Each call runs ``--sweeps`` sweeps
of every lane (``--sweeps / --g`` thinning blocks in one launch), timed
with CUDA events.

    python -m basicrta_torch.scripts.abench [--sweeps 2000] [--reps 5]
        [--variants full,tree_nat] [--layout mixed|uniform|kmaxN]
        [--residues 300] [--chains 1] [--g 100] [--ncomp 15]

Variants are the options the port's kernels have: ``full`` / ``btrs_h4``
(the production kernel), ``tree_nat`` (the tree multinomial, K4, at the
production flags), and the layout variants ``mixed``, ``uniform`` and
``kmax2``..``kmax12`` (k-way mixed packing with at most N members a
physical lane). Prints per-bucket µs/sweep, the aggregate lane-sweeps/s
and ``vpu_transcendental_util`` of every variant.

``--device cpu`` runs the plain versions on the host, for tests: its
table holds host seconds and makes no claim about the card.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Sequence

import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch, cuda_sweep
from basicrta_torch.sampler.kernels import MixtureState, init_mixture_params

VARIANTS = {
    "full": dict(),                     # the production kernel
    "btrs_h4": dict(),                  # its BTRS form's name in the JAX A/B
    "tree_nat": dict(tree=True),        # K4 at the production flags
    "mixed": dict(layout="mixed"),
    "uniform": dict(layout="uniform"),
}


def parse_variant(name: str) -> dict:
    """A variant's kernel options and layout; raises for the JAX package's
    variants whose options the port does not have."""
    if name in VARIANTS:
        return dict(VARIANTS[name])
    if name.startswith("kmax") and name[4:].isdigit() \
            and 2 <= int(name[4:]) <= 12:
        return dict(layout=name)
    raise ValueError(
        f"variant {name!r} is not in the port: its kernel option (another "
        f"BTRS accept test or loop shape, the ablation ladder, the "
        f"conjugate orientation, a VMEM group cap) is on ROADMAP.md's "
        f"'Not to port' list; the port's variants are "
        f"{sorted(VARIANTS)} and kmax2..kmax12")


def layout_batches(lanes: Dict, layout: str) -> List[batch.ResidueBatch]:
    """The buckets of one layout: the production layout (k-way mixed
    packing), the uniform packed ladder, or mixed packing capped at N
    members a lane."""
    if layout == "uniform":
        return batch.bucket_residues(lanes, mixed_pack=False)
    if layout.startswith("kmax"):
        return batch.bucket_residues(lanes, kmax=int(layout[4:]))
    return batch.bucket_residues(lanes)


def _bucket_runs(batches: Sequence, cfg: GibbsConfig, n_blocks: int,
                 device) -> list:
    """Per bucket, a closure running ``n_blocks`` blocks of every lane
    through K2 or K3 (the variant's options as keywords)."""
    runs = []
    for bi, b in enumerate(batches):
        vals, cnts, tiers, seg_id, _, Bs = batch._kernel_layout(b)
        v = torch.as_tensor(vals, dtype=torch.float32, device=device)
        c = torch.as_tensor(cnts, dtype=torch.float32, device=device)
        seg = None if seg_id is None else torch.as_tensor(seg_id,
                                                          device=device)
        st0 = init_mixture_params(cfg.ncomp, device=device)
        st = MixtureState(st0.weights.repeat(Bs, 1), st0.rates.repeat(Bs, 1))

        def go(opts, bi=bi, b=b, v=v, c=c, tiers=tiers, seg=seg, st=st):
            if b.pack > 1:
                return cuda_sweep.segment_packed(bi + 1, 0, st, v, c, cfg,
                                                 n_blocks, tiers, b.pack,
                                                 seg, **opts)
            return cuda_sweep.segment(bi + 1, 0, st, v, c, cfg, n_blocks,
                                      tiers, **opts)
        runs.append(go)
    return runs


def run_ab(layouts: Dict[str, Sequence], variants: Sequence[str],
           sweeps: int = 2000, reps: int = 5, g: int = 100, K: int = 15,
           device="cuda", ceiling=None, layout: str = "mixed") -> dict:
    """Interleaved A/B of ``variants`` on prebuilt bucket ``layouts``
    ({layout name: buckets}); a variant that names no layout takes
    ``layout``. Returns {variant: dict(layout, us_per_sweep per bucket,
    agg lane-sweeps/s, util)}; ``util`` is None on the CPU, where the
    times are host seconds."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = GibbsConfig(ncomp=K, niter=sweeps, g=g)
    n_blocks = sweeps // g
    opts = {v: parse_variant(v) for v in variants}
    vlayout = {v: opts[v].pop("layout", layout) for v in variants}
    runs = {lay: _bucket_runs(layouts[lay], cfg, n_blocks, device)
            for lay in set(vlayout.values())}

    def timed(fn):
        if not on_card:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3

    if on_card:                         # build and warm every bucket once
        for v in variants:
            for go in runs[vlayout[v]]:
                go(opts[v])
        torch.cuda.synchronize(device)
    times: Dict[tuple, list] = {}
    for _ in range(reps):
        for v in variants:
            for bi, go in enumerate(runs[vlayout[v]]):
                times.setdefault((v, bi), []).append(
                    timed(lambda: go(opts[v])))
    if on_card and ceiling is None:
        from basicrta_torch.scripts.roofline import transcendental_ceiling
        ceiling = transcendental_ceiling(device)
    out = {}
    for v in variants:
        batches = layouts[vlayout[v]]
        best = [min(times[(v, bi)]) for bi in range(len(batches))]
        agg = sum(b.size for b in batches) * sweeps / sum(best)
        util = None
        if on_card:
            from basicrta_torch.scripts.roofline import \
                vpu_transcendental_util
            util = vpu_transcendental_util(batches, agg, cfg, ceiling)
        out[v] = dict(layout=vlayout[v], agg=agg, util=util,
                      us_per_sweep=[t / sweeps * 1e6 for t in best])
    return out


def format_table(result: dict, on_card: bool) -> List[str]:
    """The A/B table: one line per variant."""
    unit = "us/sweep" if on_card else "host us/sweep (not the card)"
    lines = [f"{'variant':10s} layout   per-bucket {unit}  "
             f"agg_lane_sweeps/s  vpu_transcendental_util"]
    for v, r in result.items():
        util = "not measured" if r["util"] is None else f"{r['util']:.4f}"
        lines.append(f"{v:10s} {r['layout']:8s} "
                     + " ".join(f"{p:9.2f}" for p in r["us_per_sweep"])
                     + f"  {r['agg']:,.0f}  {util}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="basicrta_torch.scripts.abench")
    ap.add_argument("--sweeps", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--residues", type=int, default=300)
    ap.add_argument("--chains", type=int, default=1,
                    help="lanes per residue (the CLI runs 2)")
    ap.add_argument("--flagship-events", type=int, default=None,
                    help="events of the flagship residue (default: the "
                         "W313 dataset's 446,605)")
    ap.add_argument("--variants", default="full,tree_nat")
    ap.add_argument("--g", type=int, default=100)
    ap.add_argument("--ncomp", type=int, default=15)
    ap.add_argument("--layout", default="mixed",
                    help="layout of variants that name none: mixed, "
                         "uniform or kmaxN")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cpu runs the plain versions, for tests")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("abench: no CUDA device (pass --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 1
    from basicrta_torch.scripts.workload import W313_EVENTS, make_workload
    variants = args.variants.split(",")
    for v in variants:
        parse_variant(v)
    residues = make_workload(args.residues,
                             flagship=args.flagship_events or W313_EVENTS)
    lanes = {f"R{i}#{c}": t for i, t in residues.items()
             for c in range(args.chains)}
    names = {parse_variant(v).get("layout", args.layout) for v in variants}
    layouts = {lay: layout_batches(lanes, lay) for lay in names}
    for lay, bs in layouts.items():
        print(f"[{lay}] buckets (V, pack, lanes): "
              f"{[(b.values.shape[1], b.pack, b.size) for b in bs]}",
              file=sys.stderr)
    result = run_ab(layouts, variants, args.sweeps, args.reps, args.g,
                    args.ncomp, device=args.device, layout=args.layout)
    for line in format_table(result, args.device == "cuda"):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
