"""Where one sweep's time goes inside the sweep kernels, on the card.

Builds ``csrc/sweep.cu`` a second time with ``-DBASICRTA_PHASES``: that
build stamps ``clock64()`` at the phase boundaries of every thread's sweep
and keeps, per phase, the sum, the largest and the smallest of the
threads' totals. The phases:

    state     reseeding for the sweep
    suffix    the K suffix sums of the thread's columns
    head      the binomial chain (or tree) of its head-tier columns, each
              stage's draw reduced over the warp as it is made
    small     ... of its small-tier columns
    single    ... of its singleton columns
    reduce    from the thread's last row to the first barrier
    conjugate the slot totals, the Dirichlet/Gamma draw and normalisation

The compiler reads the clock for a stamp that follows a barrier before the
barrier releases, so a thread's wait for the block at the first barrier
shows under ``conjugate`` and its wait for the conjugate draw at the
second under ``state``: the slowest thread's ``head`` (or ``small``), the
fastest thread's ``conjugate`` (the draw itself) and the suffix sums add up
to the sweep. ``head_stages`` splits the head warps' stages by the
samplers their 32 columns took (none, CDF inversion only, BTRS only, both
one after the other): stages a sweep over all head warps, and the cycles
of one, stamps and the stage's reduction included (a stage of kind
``none`` is that overhead alone).

For the flagship bucket (2 x 1024), a uniform pack-2 bucket and every
bucket of protein-300 x 2 chains on the production and pow2 layouts it
prints one JSON line: cycles a sweep per phase (mean over threads, slowest
and fastest thread), the block's threads, and µs a sweep by CUDA events
of the ordinary build beside the profiling build's.

    python -m basicrta_torch.scripts.sweep_phases [--sweeps 1000]

``--probe`` instead times the flagship bucket's K2 (the ordinary build)
with the block's thread count forced to 128 ... 1,024, for the whole lane
and with only one tier's rows left non-empty.

``--variants NAME=SOURCE[:DEFINE,...] ...`` instead times the same buckets
on several builds of the kernels, turn and turn about, twice: each variant
is a source file under ``csrc/`` (``sweep.cu`` or a trial copy beside it)
with its preprocessor symbols, e.g. ``base=sweep.cu trial=sweep_trial.cu``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch, cuda_sweep
from basicrta_torch.scripts import abench

PHASES = ("state", "suffix", "head", "small", "single", "reduce",
          "conjugate")
STAGE_KINDS = ("none", "inversion", "btrs", "both")


def _read(lib, reset: bool):
    """(sums, maxima, minima of the threads' phase cycles, {stage kind:
    (count, cycles)} of the head warps' stages)."""
    n, m = len(PHASES), len(STAGE_KINDS)
    buf = (ctypes.c_ulonglong * (3 * n + 2 * m))()
    rc = lib.basicrta_phases(buf, int(reset))
    if rc != 0:
        raise RuntimeError(f"basicrta_phases: CUDA error {rc}")
    stages = {kind: (buf[3 * n + i], buf[3 * n + m + i])
              for i, kind in enumerate(STAGE_KINDS)}
    return list(buf[:n]), list(buf[n:2 * n]), list(buf[2 * n:3 * n]), stages


def _us(go, reps: int) -> float:
    """µs a launch over ``reps`` launches, after the caller's warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        go({})
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def buckets(residues=300):
    """(label, bucket) of every profiled bucket."""
    from basicrta_torch.scripts.workload import make_workload
    work = make_workload(residues)
    lanes = {f"R{i}#{c}": t for i, t in work.items() for c in range(2)}
    out = [("flagship", batch.bucket_residues(
        {"R0#0": work[0], "R0#1": work[0]}, ladder="pow2")[0])]
    uniform = max((b for b in batch.bucket_residues(lanes, consolidate=False)
                   if b.pack == 2), key=lambda b: b.values.shape[1])
    out.append(("uniform_p2", uniform))
    for b in batch.bucket_residues(lanes):
        out.append((f"production_p{b.pack}", b))
    for b in batch.bucket_residues(lanes, ladder="pow2"):
        out.append((f"pow2_v{b.values.shape[1]}", b))
    return out


def probe(sweeps: int, dev) -> None:
    """K2 on the flagship bucket with the block's thread count forced,
    for the whole lane and with one tier's rows alone left non-empty. A
    tier alone is another posterior (fewer live components, so fewer
    stages with a remainder): it bounds that tier's share of the sweep
    from below, no more."""
    from basicrta_torch.scripts.workload import make_workload
    cfg = GibbsConfig(ncomp=15, niter=sweeps, g=100)
    work = make_workload(1)
    b = batch.bucket_residues({"R0#0": work[0], "R0#1": work[0]},
                              ladder="pow2")[0]
    tiers = batch._kernel_layout(b)[2]
    row = np.arange(b.values.shape[1]) // 128
    keep = {"all": row >= 0, "head": row < tiers[0],
            "small": (row >= tiers[0]) & (row < tiers[1]),
            "single": row >= tiers[1]}
    natural = cuda_sweep.block_threads
    for name, mask in keep.items():
        b2 = dataclasses.replace(b, counts=b.counts * mask[None, :])
        go = abench._bucket_runs([b2], cfg, sweeps // cfg.g, dev)[0]
        for threads in (128, 256, 512, 1024):
            cuda_sweep.block_threads = lambda SL, tree=False, t=threads: t
            try:
                go({})
                us = _us(go, 3) / sweeps
            finally:
                cuda_sweep.block_threads = natural
            print(json.dumps(dict(probe="flagship", rows=name,
                                  row_tiers=list(tiers), threads=threads,
                                  us_per_sweep=round(us, 3))), flush=True)


def compare(variants, sweeps: int, dev) -> None:
    """µs a sweep of every bucket on each of ``variants``
    ([(name, source, defines)]), interleaved, two passes."""
    cfg = GibbsConfig(ncomp=15, niter=sweeps, g=100)
    libs = [cuda_sweep._bind(cuda_sweep.build_library(
        True, source=source, defines=defines))
        for _, source, defines in variants]
    try:
        for _ in range(2):
            for label, b in buckets():
                go = abench._bucket_runs([b], cfg, sweeps // cfg.g, dev)[0]
                row = dict(bucket=label)
                for (name, _, _), lib in zip(variants, libs):
                    cuda_sweep._lib = lib
                    go({})
                    row[name] = round(_us(go, 3) / sweeps, 3)
                print(json.dumps(row), flush=True)
    finally:
        cuda_sweep._lib = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="basicrta_torch.scripts.sweep_phases")
    ap.add_argument("--sweeps", type=int, default=1000)
    ap.add_argument("--residues", type=int, default=300)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--variants", nargs="+", default=None,
                    metavar="NAME=SOURCE[:DEFINE,...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if args.probe:
        probe(args.sweeps, dev)
        return 0
    if args.variants:
        parsed = []
        for spec in args.variants:
            name, _, rest = spec.partition("=")
            source, _, defines = rest.partition(":")
            parsed.append((name, source,
                           tuple(d for d in defines.split(",") if d)))
        compare(parsed, args.sweeps, dev)
        return 0
    cfg = GibbsConfig(ncomp=15, niter=args.sweeps, g=100)
    n_blocks = args.sweeps // cfg.g
    plain = cuda_sweep._bind(cuda_sweep.build_library())
    prof = cuda_sweep._bind(cuda_sweep.build_library(
        True, defines=("BASICRTA_PHASES",)))
    prof.basicrta_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    prof.basicrta_phases.restype = ctypes.c_int
    for label, b in buckets(args.residues):
        go = abench._bucket_runs([b], cfg, n_blocks, dev)[0]
        vals = batch._kernel_layout(b)[0]
        Bph, SL = vals.shape[0] // (b.pack if b.bounds is None else 1), \
            vals.shape[1] * (b.pack if b.bounds is None else 1) // 128
        threads = cuda_sweep.block_threads(SL)
        cuda_sweep._lib = plain
        go({})
        us = _us(go, 3) / args.sweeps
        cuda_sweep._lib = prof
        go({})
        torch.cuda.synchronize()
        _read(prof, True)
        us_prof = _us(go, 1) / args.sweeps
        total, most, least, stages = _read(prof, False)
        per = float(args.sweeps)
        row = dict(bucket=label, pack=b.pack, Bph=Bph, SL=SL, lanes=b.size,
                   threads=threads, us_per_sweep=round(us, 3),
                   us_per_sweep_profiled=round(us_prof, 3))
        for i, name in enumerate(PHASES):
            row[name] = dict(
                mean=round(total[i] / (per * Bph * threads), 1),
                max=round(most[i] / per, 1), min=round(least[i] / per, 1))
        # a head warp's stages by the samplers its columns took: how many
        # a sweep over all head warps, and the cycles of one
        row["head_stages"] = {
            kind: dict(per_sweep=round(cnt / per, 2),
                       cycles=round(cyc / max(cnt, 1), 1))
            for kind, (cnt, cyc) in stages.items()}
        print(json.dumps(row), flush=True)
    cuda_sweep._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
