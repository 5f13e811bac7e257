"""Interleaved A/B of contacts-mapper configurations on the card.

Port of the JAX package's ``scripts/cbench.py``: the adaptive prefilter
cap against a pinned static cap and the dense kernel on bench.py's
membrane workload (300 x 16 atoms against 200 lipids x 50 in a 120 x 120 x
90 A box, ``basicrta_torch.scripts.workload.make_membrane_frames``),
interleaved across reps. Every variant's rows must equal the dense
kernel's: the adaptive cap must never change the output.

Usage:
    python -m basicrta_torch.scripts.cbench [--reps 5] [--frames 96]
        [--device cpu]
"""

import argparse
import time

import numpy as np

from basicrta_torch.config import ContactConfig
from basicrta_torch.contacts.mapper import MapContacts
from basicrta_torch.contacts.records import ContactMeta

VARIANTS = {
    # forced prefilter, adaptive cap ('auto' keeps the dense kernel below
    # prefilter_auto_pairs, so pin it on here)
    "adaptive": ContactConfig(prefilter=True),
    # every batch at a 4096 cap
    "static4096": ContactConfig(prefilter=True, prefilter_cap_min=4096),
    # the unpruned kernel
    "dense": ContactConfig(prefilter=False),
}


def bench(batches, resids1, resids2, A1, reps, device, out=print):
    """{variant: [frames/s a rep]} after one cold run of each, whose rows
    must all equal the dense variant's."""
    n_frames = sum(len(b.frame_ids) for b in batches)
    A2 = len(resids2)
    mappers = {name: MapContacts(
        indices1=np.arange(A1), resids1=resids1,
        indices2=np.arange(A1, A1 + A2), resids2=resids2,
        cfg=cfg, meta=ContactMeta(ts=0.1), device=device)
        for name, cfg in VARIANTS.items()}
    recs = {name: mc.run(batches) for name, mc in mappers.items()}
    ref = recs["dense"]
    for name, rec in recs.items():
        for f in ("frames", "sel1_resids", "sel2_resids", "min_dist"):
            assert np.array_equal(getattr(rec, f), getattr(ref, f)), \
                (name, f)
    out(f"all variants agree: {len(ref.frames)} rows / {n_frames} frames")
    fps = {name: [] for name in mappers}
    for rep in range(reps):
        for name, mc in mappers.items():
            t0 = time.perf_counter()
            mc.run(batches)           # returns host rows: synchronized
            fps[name].append(n_frames / (time.perf_counter() - t0))
            out(f"rep {rep} {name}: {fps[name][-1]:,.1f} frames/s")
    return fps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (the default; raises without one) or "
                         "the CPU")
    args = ap.parse_args(argv)

    from basicrta_torch.scripts.workload import make_membrane_frames
    batches, resids1, resids2, A1 = make_membrane_frames(
        n_frames=args.frames)
    fps = bench(batches, resids1, resids2, A1, args.reps, args.device,
                out=lambda s: print(s, flush=True))
    print("\n== medians ==")
    for name, xs in fps.items():
        print(f"{name:12s} {float(np.median(xs)):10,.1f} frames/s "
              f"(median of {args.reps})")
    return fps


if __name__ == "__main__":
    main()
