#!/usr/bin/env python3
"""Smoke run of basicrta_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--only 5,8,9,10,11,12,13]

With no arguments every phase runs and the result lines are printed;
``--only`` runs phase 1 and the named phases that stand alone (5, 8, 9,
10, 11, 12, 13; 9 runs 8a and the flagship residue of phase 4 first, 10
the flagship) and prints no result.

Phases (each raises on failure, so any failure exits non-zero):

1. the card's name and power limit; build the CUDA kernels from
   ``basicrta_torch/csrc`` (one nvcc per source) and the trajectory codec
   from ``basicrta_torch/native`` (g++), all started together.
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: K1/K2 on the pow2 flagship bucket (the 446,605-event
   W313-scale residue x 2 chains, V = 1024, K = 15) and a 128-column
   bucket of >= 256 lanes; K3 on protein-300's production bucket with the
   most physical lanes (mixed widths, pack >= 4) and on a uniform pack-2
   multi-row bucket, each with a bitwise resume check. K2 and K3 are timed
   at 10 sweeps a launch and at 1,000 (the sweep loop apart from the
   launch).
3. the protein: 300 residues (basicrta_torch.scripts.workload) x 2 chains
   through the CLI ``gibbs`` (10,000 sweeps, one production segment) and
   ``cluster`` commands, on the production layout (K3 for the packed
   buckets, K2 for any unpacked one) with bucketed post-processing; every
   residue must get a finite tau and a CI with 0 <= lo <= hi (a tau outside
   its own CI is reported, not failed: the estimator's histogram mode can
   leave the percentile CI), and the run must have launched the fused
   kernels, never a plain version. A profiled re-run of the
   post-processing counts its device activities per residue. Then the
   same 300 x 2 lanes run the same sweeps on the pow2 ladder (K2 only),
   sampling only, so both layouts' lane-sweeps/s stand side by side:
   bucket after bucket (``run_batch``) and every bucket on the card at
   once (``run_batches``, what ``run_residues`` does).
4. full-length runs through ``Gibbs``: the verify recipe (5e4 events,
   niter 11,000, its 95% CI must cover the slowest truth tau = 50) and the
   flagship residue at the default GibbsConfig (110,000 sweeps).
5. the device-PRNG probe (K5) against its plain version (uniform bits
   identical; tile t of a many-tile launch bitwise a one-tile launch at
   its seed), its time over 4,096 tiles in one launch beside the one-tile
   (launch) time and ``torch.rand`` / ``torch.binomial`` /
   ``torch._standard_gamma`` at the same size, the last tile of each timed
   launch against the plain version, the
   counters of K5's stats build for each timed sampler beside those of one
   thread per element, then the goodness-of-fit battery on the kernel's
   draws (one launch a sample).
6. the tree multinomial (K4) in its three kernel forms against the plain
   tree: K1's and K2's on phase 2's pow2 buckets, K3's on its packed
   buckets, with K1-K3's pass rules and bitwise resume; exact totals and
   the moment check over 8 seeds; then the kernel A/B
   (``basicrta_torch.scripts.abench``) of ``full`` against ``tree_nat`` on
   protein-300's production layout, 2,000 sweeps, 3 reps.
7. the transcendental ceiling (K6) against its plain version (rtol 1e-6),
   the ceiling in exp/s beside the SFU peak, ``vpu_transcendental_util``
   of phase 3's production and pow2 layouts, and each kernel's bound.
8. the contacts path, from a trajectory file to tau. 8a: the membrane
   workload (14,800 atoms, 2,000 frames) written as ``.gro`` + ``.xtc``
   with the port's codec, then the CLI's ``contacts``, ``gibbs`` (the three
   residues with the most events, 10,000 sweeps) and ``cluster``; rows of
   sampled frames are held against the plain host version
   (``basicrta_torch.scripts.contacts_reference``), labels must come from
   the topology, every tau must be finite with 0 <= lo <= hi, and the
   sweep kernels must have launched. 8b: the bilayer workload (101,400
   atoms, 48 frames) from an XTC file through ``Universe.iter_batches``
   and ``MapContacts.run`` under both wire formats: the pruned path must
   be taken with no dense fallback, its rows must equal the dense
   kernel's on one batch and the host version's on sampled frames; warm
   frames/s, decode, host prepare and device seconds a frame, and the
   device's busy share by ``torch.profiler`` are printed.
9. kinetics and weighted densities. 9a: 8a's residue with the most events
   through the CLI ``kinetics --wdensity --comp-trajs --top_n 100`` (xtc,
   then dcd): every ``.dx`` must read back, every trajectory must hold
   its rows' frames, the card's densities must equal the CPU's at rtol
   1e-5 of the largest value; then each step through ``MapKinetics`` on
   the card, timed (``weighted_densities`` over all rows with the card's
   busy share), and grid plus spill must equal the frame weights times
   the live atoms. 9b: the flagship residue of phase 4 (446,605 events)
   given a seeded event table over membrane-2000 (its times; starts on
   the 0.1 ns grid; lipids that touch 9a's residue); its frame table (the
   memmap branch, ~3.78M rows) against a numpy expansion, then every row
   streamed through ``GridAccumulator`` on the card at the default 40 A
   grid, positions gathered on the host from the decoded frames: rows/s,
   device ms a chunk by CUDA events, the busy share, host gather and
   upload seconds, the same rows with one readback a chunk (the JAX
   package's design), and the plain CPU version on the first 100,000
   rows, whose grids the card's must equal.
10. the sweep kernels held in law against independent samplers. 10a:
   simulation-based calibration (``basicrta_torch.scripts.sbc`` at its
   defaults: 64 replicates of 2,000 events, K = 5, 20,000 sweeps) on the
   'cuda' engine with uniform sizes and with mixed sizes (K2/K3, never a
   plain version) and on the 'collapsed' engine, each at seeds 0, 1, 2: a
   functional fails when its rank-uniformity p is below 0.001 at any seed
   or below 0.01 at two. 10b: the numpy reference-semantics sampler
   against the 'cuda' and 'collapsed' engines on
   ``tests/test_equivalence.py``'s dataset and rules. 10c: the reference
   collapsed and dense chains (``Gibbs.run(mode=...)``) on the flagship
   residue: us and kernels a sweep, the card's busy share, finite tau,
   the collapsed CI against phase 4's. 10d: ``scripts/validate.py``'s
   full protein at 110,000 sweeps x 2 chains on the 'cuda' engine (sampling
   and post-processing seconds, finite tau, the split-R-hat distribution),
   then its 4 highest-R-hat residues on the 'collapsed' engine.
11. sharding (``basicrta_torch.parallel``), on two shards of the one card
   (or over every card when several are visible). 11a: protein-300 x 2
   chains, K = 15, 10,000 sweeps, production layout:
   ``ParallelGibbs.run(n_devices=0)`` must be bitwise the unsharded run
   (samples and tau); then ``run_residues`` on a lane-sharded mesh and
   sharded post-processing (every tau finite, 0 <= lo <= hi; K3 launched,
   never a plain version), K3's first 2 sweeps on each shard of the
   largest mixed bucket against its plain version at the shard's seed,
   and the sampling seconds unsharded and sharded. 11b: 4 lanes of a
   5,000-event residue on the 'collapsed' engine over a (2 lanes, 2
   events) mesh, 2,000 sweeps, against the unsharded run in law. 11c:
   256 membrane frames through ``MapContacts`` with their frames sharded
   (rows equal to unsharded) and the CLI ``contacts --ndevices 0`` (equal
   to no flag). 11d: ``GridAccumulator`` on a sharded mesh against one
   device (rtol 1e-5 of a grid's largest voxel).
12. the tools (``basicrta_torch.scripts``): reference pickles through
   ``gibbs``, ``cluster`` and ``kinetics`` (12a), the layout refit and
   ranking (12b-c), ``postbench`` and ``cbench`` (12d-e), ``e2e_demo`` and
   ``entry`` (12f-g).
13. ``contacts`` through the CLI on the card from each file family. 13a:
   the membrane of 8a at 96 frames as ``.xtc``, ``.trr``, ``.dcd`` and
   ``.ncdf`` (the port's writers), frames/s a format; the f32 formats'
   rows equal a ``--device cpu`` run's on the same file, and the ``.trr``
   rows the ``.dcd`` rows, but for pairs within 1e-4 A of the cutoff.
   13b: a raw ``.tpr`` through a stub ``gmx`` on ``BASICRTA_GMX``,
   rewritten with the same size and mtime: 2 renders and the new
   topology's rows. 13c: ``prmtop`` + NetCDF and PSF + TRR fixtures, rows
   equal the CPU's under the same gate.

Output: one JSON line of per-kernel results (each with its bound, and the
time of one PyTorch call that computes the same function where there is
one), the card's ``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PROTEIN_SWEEPS = 10_000   # one production segment (bench.py TIMED_SWEEPS)
AB_SWEEPS, AB_REPS = 2000, 3   # phase 6's kernel A/B (scripts/abench.py)
LONG_SWEEPS = 1000             # phase 2's long launches of K2 and K3
MEMBRANE_FRAMES = 2000         # phase 8a's trajectory


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _agree(W, R, W2, R2, rows=None):
    """Fraction of lanes whose thinned (W, R) agree at rtol 1e-4."""
    import torch
    ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
          & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))
    return (ok if rows is None else ok[rows]).float().mean().item()


def pow2_buckets(workload):
    """K1/K2's buckets: the flagship residue x 2 chains on the pow2 ladder
    (2 x 1024) and a 128-column bucket of >= 256 lanes."""
    from basicrta_torch.sampler.batch import bucket_residues
    flag = bucket_residues({"R0#0": workload[0], "R0#1": workload[0]},
                           ladder="pow2")
    require(len(flag) == 1 and flag[0].values.shape == (2, 1024),
            f"flagship bucket is {[b.values.shape for b in flag]}")
    small = {i: t for i, t in workload.items()
             if len(np.unique(t)) <= 128}
    chains = -(-256 // len(small))
    b128 = bucket_residues({f"R{i}#{c}": t for i, t in small.items()
                            for c in range(chains)}, ladder="pow2")
    require(len(b128) == 1 and b128[0].values.shape[1] == 128
            and b128[0].size >= 256, "128-column bucket")
    return (("flagship", flag[0]), ("b128", b128[0]))


def packed_bytes(v, Bs, K):
    """Bytes one 10-sweep K3 launch must move: physical values and counts,
    the slot ids, the state in, one thinned block and the final state."""
    return int(8 * v.numel() + 4 * 128 * v.shape[0] + 24 * Bs * K)


def packed_buckets(workload):
    """K3's buckets: protein-300 x 2 chains' production bucket with the
    most physical lanes (mixed widths, pack >= 4) and the widest uniform
    pack-2 bucket."""
    from basicrta_torch.sampler import batch
    lanes = {f"R{i}#{c}": t for i, t in workload.items() for c in range(2)}
    mixed = max((b for b in batch.bucket_residues(lanes)
                 if b.bounds is not None), key=lambda b: len(b.bounds))
    require(mixed.pack >= 4, f"largest production bucket packs "
            f"{mixed.pack}-way")
    uniform = max((b for b in batch.bucket_residues(lanes, consolidate=False)
                   if b.pack == 2), key=lambda b: b.values.shape[1])
    require(uniform.values.shape[1] > 64, "uniform pack-2 bucket is one row")
    return (("mixed", mixed), ("uniform_p2", uniform))


def kernel_checks(workload):
    """Phase 2: K1 and K2 against their plain versions on the card."""
    import torch
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.scripts.roofline import needed_transcendentals
    from basicrta_torch.sampler.kernels import MixtureState, \
        init_mixture_params

    dev = torch.device("cuda")
    K = 15
    buckets = pow2_buckets(workload)
    flag = [buckets[0][1]]
    report = {}
    cfg_long = GibbsConfig(ncomp=K, niter=LONG_SWEEPS, g=100)
    for label, batch in buckets:
        B, V = batch.values.shape
        v = torch.tensor(batch.values, dtype=torch.float32, device=dev)
        c = torch.tensor(batch.counts, dtype=torch.float32, device=dev)
        tiers = cs.pad_tiers_to_rows(batch.tiers, V)
        st0 = init_mixture_params(K, device=dev)
        st = MixtureState(st0.weights.repeat(B, 1), st0.rates.repeat(B, 1))

        ns, ts = cs.sweep_stats(7, st, v, c, K, tiers)
        pn, pt = cs.sweep_stats_torch(7, st, v, c, K, tiers)
        torch.cuda.synchronize()
        require(torch.equal(ns.sum(1), c.sum(1)), f"{label} K1 N totals")
        same = (ns == pn).float().mean().item()
        require(same >= 0.99, f"{label} K1 N_k identical in {same:.4f}")
        k1_err = (ns - pn).abs().max().item()

        cfg1 = GibbsConfig(ncomp=K, niter=2, g=1)
        _, W, R = cs.segment(11, 0, st, v, c, cfg1, 2, tiers)
        _, W2, R2 = cs.segment_torch(11, 0, st, v, c, cfg1, 2, tiers)
        agree = _agree(W, R, W2, R2)
        require(agree >= 0.95, f"{label} K2 lanes agreeing {agree:.4f}")
        k2_err = max((W - W2).abs().max().item(),
                     (R - R2).abs().max().item())

        before = cs.sweep_stats.launches
        k1_ms = cuda_ms(lambda: cs.sweep_stats(7, st, v, c, K, tiers), 20)
        k1_launches = cs.sweep_stats.launches - before
        k1_plain = cuda_ms(
            lambda: cs.sweep_stats_torch(7, st, v, c, K, tiers), 2)
        cfg10 = GibbsConfig(ncomp=K, niter=10, g=10)
        k2_ms = cuda_ms(lambda: cs.segment(11, 0, st, v, c, cfg10, 1, tiers),
                        20)
        k2_plain = cuda_ms(
            lambda: cs.segment_torch(11, 0, st, v, c, cfg10, 1, tiers), 1)
        # 1,000 sweeps a launch: the sweep loop apart from the launch
        k2_long = cuda_ms(lambda: cs.segment(11, 0, st, v, c, cfg_long,
                                             LONG_SWEEPS // 100, tiers), 3)
        report[label] = dict(B=B, V=V, tiers=tiers, k1_same=same,
                             bytes=int(8 * B * V + 16 * B * K),
                             work=needed_transcendentals(c, B, K),
                             work_k1=needed_transcendentals(
                                 c, B, K, conjugate=False),
                             k1_launches=k1_launches,
                             k1_err=k1_err, k2_agree=agree, k2_err=k2_err,
                             k1_ms=k1_ms, k1_plain_ms=k1_plain,
                             k2_ms_10sweeps=k2_ms,
                             k2_plain_ms_10sweeps=k2_plain,
                             k2_ms_1000sweeps=k2_long,
                             k2_us_per_sweep=1e3 * k2_long / LONG_SWEEPS,
                             threads=cs.block_threads(V // 128),
                             smem_bytes=cs.block_shared_bytes(K, V // 128))
        print(f"phase 2 {label}: {json.dumps(report[label])}", flush=True)

    # 20 blocks of g = 100 on the flagship bucket; the plain version runs
    # on the host here (2,000 of its sweeps take minutes on either side)
    batch = flag[0]
    cfg = GibbsConfig(ncomp=K, niter=2000, g=100)
    st0 = init_mixture_params(K)
    runs = {}
    for name, device, fn in (("kernel", dev, cs.segment),
                             ("plain", torch.device("cpu"),
                              cs.segment_torch)):
        st = MixtureState(st0.weights.repeat(2, 1).to(device),
                          st0.rates.repeat(2, 1).to(device))
        t0 = time.time()
        _, W, R = fn(3, 0, st, torch.tensor(batch.values, dtype=torch.float32,
                                            device=device),
                     torch.tensor(batch.counts, dtype=torch.float32,
                                  device=device), cfg, 20,
                     cs.pad_tiers_to_rows(batch.tiers, 1024))
        W, R = W.cpu().numpy(), R.cpu().numpy()
        runs[name] = (W, R, time.time() - t0)
    for lane in range(2):
        Wk, Rk = runs["kernel"][0][lane, 5:], runs["kernel"][1][lane, 5:]
        Wp, Rp = runs["plain"][0][lane, 5:], runs["plain"][1][lane, 5:]
        require(np.isfinite(runs["kernel"][0]).all()
                and np.isfinite(runs["kernel"][1]).all(), "K2 finite")
        ik, ip = Wk.mean(0).argmax(), Wp.mean(0).argmax()
        for what, a, b in (("weight", Wk.mean(0)[ik], Wp.mean(0)[ip]),
                           ("rate", Rk[:, ik].mean(), Rp[:, ip].mean())):
            rel = abs(a - b) / abs(b)
            print(f"phase 2 K2 20x100 lane {lane} dominant {what}: kernel "
                  f"{a:.6g} plain {b:.6g} rel {rel:.3g}", flush=True)
            require(rel <= 0.05, f"K2 20x100 lane {lane} {what}")
    print(f"phase 2 K2 20x100: kernel {runs['kernel'][2]:.3f} s, plain "
          f"(host) {runs['plain'][2]:.3f} s", flush=True)
    return report


def packed_checks(workload):
    """Phase 2, K3: the packed kernel against its plain version on
    protein-300's production bucket with the most physical lanes and on a
    uniform pack-2 multi-row bucket; bitwise resume; 10-sweep times."""
    import torch
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler import batch
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.sampler.kernels import MixtureState, \
        init_mixture_params
    from basicrta_torch.scripts.roofline import needed_transcendentals

    dev = torch.device("cuda")
    K = 15
    report = {}
    for label, bk in packed_buckets(workload):
        vals, cnts, tiers, seg_id, slot, Bs = batch._kernel_layout(bk)
        v = torch.tensor(vals, device=dev)
        c = torch.tensor(cnts, device=dev)
        seg = None if seg_id is None else torch.tensor(seg_id, device=dev)
        rows = (torch.tensor(slot, device=dev) if slot is not None
                else torch.arange(bk.size, device=dev))
        st0 = init_mixture_params(K, device=dev)
        st = MixtureState(st0.weights.repeat(Bs, 1), st0.rates.repeat(Bs, 1))
        args = (v, c)
        cfg1 = GibbsConfig(ncomp=K, niter=2, g=1)
        s2, W, R = cs.segment_packed(11, 0, st, *args, cfg1, 2, tiers,
                                     bk.pack, seg)
        _, W2, R2 = cs.segment_packed_torch(11, 0, st, *args, cfg1, 2, tiers,
                                            bk.pack, seg)
        agree = _agree(W, R, W2, R2, rows)
        require(agree >= 0.95, f"{label} K3 lanes agreeing {agree:.4f}")
        err = max((W - W2)[rows].abs().max().item(),
                  (R - R2)[rows].abs().max().item())
        s1, Wa, Ra = cs.segment_packed(11, 0, st, *args, cfg1, 1, tiers,
                                       bk.pack, seg)
        s1, Wb, Rb = cs.segment_packed(11, 1, s1, *args, cfg1, 1, tiers,
                                       bk.pack, seg)
        resume = (torch.equal(torch.cat([Wa, Wb], 1), W)
                  and torch.equal(torch.cat([Ra, Rb], 1), R)
                  and torch.equal(s1.weights, s2.weights)
                  and torch.equal(s1.rates, s2.rates))
        require(resume, f"{label} K3 1 + 1 blocks differ from 2 blocks")
        cfg10 = GibbsConfig(ncomp=K, niter=10, g=10)
        ms = cuda_ms(lambda: cs.segment_packed(11, 0, st, *args, cfg10, 1,
                                               tiers, bk.pack, seg), 20)
        plain = cuda_ms(lambda: cs.segment_packed_torch(
            11, 0, st, *args, cfg10, 1, tiers, bk.pack, seg), 1)
        cfg_long = GibbsConfig(ncomp=K, niter=LONG_SWEEPS, g=100)
        long_ms = cuda_ms(lambda: cs.segment_packed(
            11, 0, st, *args, cfg_long, LONG_SWEEPS // 100, tiers, bk.pack,
            seg), 3)
        report[label] = dict(pack=bk.pack, Bph=v.shape[0],
                             SL=v.shape[1] // 128, lanes=bk.size,
                             bytes=packed_bytes(v, Bs, K),
                             work=needed_transcendentals(c, bk.size, K),
                             tiers=tiers, k3_agree=agree, k3_err=err,
                             resume_bitwise=resume, k3_ms_10sweeps=ms,
                             k3_plain_ms_10sweeps=plain,
                             k3_ms_1000sweeps=long_ms,
                             k3_us_per_sweep=1e3 * long_ms / LONG_SWEEPS,
                             threads=cs.block_threads(v.shape[1] // 128),
                             smem_bytes=cs.block_shared_bytes(
                                 K, v.shape[1] // 128, bk.pack))
        print(f"phase 2 K3 {label}: {json.dumps(report[label])}", flush=True)
    return report


def _device_busy(fn):
    """(wall seconds, device-busy seconds, device activities, kernels) of
    ``fn`` under torch.profiler: the union of the device activities'
    spans; the kernels are the activities that are not copies or sets."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if not _device_busy.warm:
        # the first profile of a process pays for starting the tracer
        with profile(activities=acts):
            torch.cuda.synchronize()
        _device_busy.warm = True
    t0 = time.time()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    acts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in acts)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = sum(not e.name.startswith(("Memcpy", "Memset")) for e in acts)
    return wall, busy / 1e6, len(spans), kernels


_device_busy.warm = False


def protein_run(workload, tmp):
    """Phase 3: the CLI main path on the 300-residue protein (production
    layout, batched post-processing), a profiled post-processing pass, and
    the same lanes' sampling on the pow2 ladder."""
    import torch
    from basicrta_torch import cli
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.contacts.records import ContactEvents, ContactMeta
    from basicrta_torch.protein import driver
    from basicrta_torch.sampler import batch
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.sampler.gibbs import Gibbs

    resids = np.concatenate([np.full(len(t), i + 1, np.int32)
                             for i, t in workload.items()])
    durations = np.concatenate(list(workload.values()))
    events = ContactEvents(resids, np.zeros_like(resids),
                           np.zeros_like(durations), durations,
                           ContactMeta(cutoff=7.0))
    path = os.path.join(tmp, "contacts_7.0.npz")
    events.save(path)
    seen = {"post_s": 0.0, "batched_calls": 0, "run_s": 0.0, "layout_s": 0.0,
            "buckets": []}
    originals = (driver.finish_batch, driver.process_residues_batched,
                 driver.run_residues, batch.bucket_residues)

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.time()
            out = fn(*a, **k)
            seen[key] += time.time() - t0
            return out
        return wrapper

    def batched(*a, **k):
        seen["batched_calls"] += 1
        return originals[1](*a, **k)

    def layout(*a, **k):
        t0 = time.time()
        out = originals[3](*a, **k)
        seen["layout_s"] += time.time() - t0
        seen["layout"] = out
        seen["buckets"] = [(b.pack, -(-b.size // b.pack) if b.bounds is None
                            else len(b.bounds),
                            b.phys_rows or max(1, b.values.shape[1]
                                               // (128 // b.pack)), b.size)
                           for b in out]
        return out

    driver.finish_batch = timed("post_s", originals[0])
    driver.process_residues_batched = batched
    driver.run_residues = timed("run_s", originals[2])
    batch.bucket_residues = layout
    cwd = os.getcwd()
    os.chdir(tmp)
    counters = (cs.segment, cs.segment_packed, cs.sweep_stats)
    plains = (cs.segment_torch, cs.segment_packed_torch,
              cs.sweep_stats_torch)
    try:
        for f in counters:
            f.launches = 0
        for f in plains:
            f.calls = 0
        t0 = time.time()
        # the per-residue report goes to a file, not this script's output
        with open(os.path.join(tmp, "gibbs.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            cli.main(["gibbs", "--contacts", path, "--nchains", "2",
                      "--niter", str(PROTEIN_SWEEPS)])
        gibbs_s = time.time() - t0
        launches = {f.__name__: f.launches for f in counters}
        launches.update({f.__name__: f.calls for f in plains})
        cli.main(["cluster", "--cutoff", "7.0", "--niter",
                  str(PROTEIN_SWEEPS)])
        wall = time.time() - t0
        taus = np.load(os.path.join(tmp, "tausout.npy"))
    finally:
        os.chdir(cwd)
        (driver.finish_batch, driver.process_residues_batched,
         driver.run_residues, batch.bucket_residues) = originals
    require(launches["segment_packed"] > 0, f"K3 never launched: {launches}")
    require(all(launches[f.__name__] == 0 for f in plains),
            f"plain versions ran on the main path: {launches}")
    require(seen["batched_calls"] > 0, "post-processing bypassed batched.py")
    require(taus.shape == (len(workload), 4), f"tausout {taus.shape}")
    tau, lo, hi = taus[:, 1], taus[:, 2], taus[:, 3]
    require(np.isfinite(taus).all(), "non-finite tau")
    require(np.all((0 <= lo) & (lo <= hi) & (tau >= 0)), "malformed CI")
    # tau is the midpoint of the tallest of 15 equal histogram bins and the
    # CI the 2.5/97.5 percentiles (reference gibbs.py:691-715): a few huge
    # 1/rate samples widen the bins until that midpoint leaves the CI
    outside = np.nonzero((tau < lo) | (tau > hi))[0]
    if outside.size:
        print(f"phase 3 tau outside its CI (histogram-mode estimator): "
              f"{taus[outside].tolist()}", flush=True)
    lane_sweeps = 2 * len(workload) * PROTEIN_SWEEPS
    sample_s = seen["run_s"] - seen["layout_s"]
    print(f"phase 3 buckets (pack, Bph, SL, lanes): {seen['buckets']}; "
          f"layout host time {seen['layout_s']:.2f} s", flush=True)
    print(f"phase 3 protein: {len(workload)} residues x 2 chains x "
          f"{PROTEIN_SWEEPS} sweeps, production layout; wall {wall:.2f} s "
          f"(gibbs {gibbs_s:.2f} s: run_residues {seen['run_s']:.2f} s of "
          f"which layout {seen['layout_s']:.2f} s, post-processing "
          f"{seen['post_s']:.2f} s = "
          f"{1000 * seen['post_s'] / len(workload):.1f} ms/residue); "
          f"sampling {lane_sweeps / sample_s:,.0f} lane-sweeps/s "
          f"({lane_sweeps / seen['run_s']:,.0f} with the layout); launches "
          f"{json.dumps(launches)}; zero-tau residues "
          f"{int((tau == 0).sum())}; tau outside CI {outside.size}",
          flush=True)

    # device activities of the post-processing, profiled on a re-run
    base = os.path.join(tmp, "basicrta-7.0")
    loaded = {}
    for lab in sorted(os.listdir(base)):
        f = os.path.join(base, lab, f"gibbs_{PROTEIN_SWEEPS}.npz")
        if os.path.exists(f):
            loaded[lab] = Gibbs.load(f)
    prof_s, busy, n_acts, _ = _device_busy(
        lambda: driver.finish_batch(loaded, save=False))
    print(f"phase 3 post-processing profiled: {len(loaded)} residues in "
          f"{prof_s:.2f} s (profiler on), "
          f"{n_acts / len(loaded):,.0f} device activities per "
          f"residue, device busy {busy:.3f} s "
          f"({100 * busy / prof_s:.1f}%)", flush=True)

    # the same lanes and sweeps on the pow2 ladder: K2's path, sampling only
    times = {f"X{i + 1}": t for i, t in workload.items()}
    cfg = GibbsConfig(niter=PROTEIN_SWEEPS, n_chains=2)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0
    t0 = time.time()
    pow2 = batch.bucket_residues({f"{k}#{c}": t for k, t in times.items()
                                  for c in range(2)}, ladder="pow2")
    layout_s = time.time() - t0
    batch.run_residues(times, cfg, n_chains=2, ladder="pow2", engine="cuda")
    torch.cuda.synchronize()
    run_s = time.time() - t0 - layout_s
    pow2_launches = {f.__name__: f.launches for f in counters}
    pow2_launches.update({f.__name__: f.calls for f in plains})
    require(pow2_launches["segment"] > 0, f"K2 never launched: "
            f"{pow2_launches}")
    require(all(pow2_launches[f.__name__] == 0 for f in plains),
            f"plain versions ran on the pow2 path: {pow2_launches}")
    print(f"phase 3 pow2: buckets (V, lanes) "
          f"{[(b.values.shape[1], b.size) for b in pow2]}; run_residues "
          f"{run_s:.2f} s -> {lane_sweeps / (run_s - layout_s):,.0f} "
          f"lane-sweeps/s sampling (layout {layout_s:.2f} s, counted once "
          f"here and once inside run_residues); launches "
          f"{json.dumps(pow2_launches)}", flush=True)

    # each bucket of both layouts through run_batch, sampling only, under
    # the same conditions (no checkpoints, no progress syncs)
    layouts = {}
    for name, layout_ in (("production", seen["layout"]), ("pow2", pow2)):
        secs = []
        for b in layout_:
            t0 = time.time()
            batch.run_batch(b, cfg, engine="cuda")
            torch.cuda.synchronize()
            secs.append(round(time.time() - t0, 3))
        # and every bucket on the card at once, a stream each: what
        # run_residues does
        t0 = time.time()
        batch.run_batches(layout_, cfg, engine="cuda")
        torch.cuda.synchronize()
        together = time.time() - t0
        print(f"phase 3 {name} per bucket (s): {secs}; in series "
              f"{sum(secs):.3f} s -> {lane_sweeps / sum(secs):,.0f} "
              f"lane-sweeps/s; concurrent {together:.3f} s -> "
              f"{lane_sweeps / together:,.0f} lane-sweeps/s", flush=True)
        layouts[name] = (layout_, lane_sweeps / sum(secs))
    return launches, pow2_launches, layouts


def full_runs(workload, tmp):
    """Phase 4: the verify recipe and the flagship at default settings."""
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler.gibbs import Gibbs
    from basicrta_torch.scripts.workload import discretize, simulate_hyperexp

    x = discretize(simulate_hyperexp(5e4, [0.8, 0.17, 0.03],
                                     [3.0, 0.25, 0.02],
                                     np.random.default_rng(11)))
    cfg = GibbsConfig(ncomp=10, niter=11000, g=100, burnin=1000,
                      gmm_n_init=32)
    t0 = time.time()
    g = Gibbs(x, residue="W313", cutoff=7.0, cfg=cfg, root=tmp).run()
    g.process_gibbs()
    lo, tau, hi = g.estimate_tau()
    g2 = Gibbs.load(g.save())
    require(g2.processed.lmode == g.processed.lmode, "artifact round trip")
    print(f"phase 4 verify recipe: tau {tau:.3f} CI [{lo:.3f}, {hi:.3f}] "
          f"lmode {g.processed.lmode} in {time.time() - t0:.2f} s",
          flush=True)
    require(lo <= 50.0 <= hi, "verify recipe CI misses tau = 50")

    t0 = time.time()
    g = Gibbs(workload[0], residue="R0", cutoff=7.0, root=tmp).run()
    run_s = time.time() - t0
    g.process_gibbs()
    lo, tau, hi = g.estimate_tau()
    require(np.isfinite([lo, tau, hi]).all() and lo <= tau <= hi,
            "flagship tau")
    print(f"phase 4 flagship default cfg (K2's headline): 110,000 sweeps "
          f"in {run_s:.2f} s ({110_000 / run_s:,.0f} sweeps/s, "
          f"{1e6 * run_s / 110_000:.2f} us a sweep, 11 launches of "
          f"10,000), total with post-processing "
          f"{time.time() - t0:.2f} s; tau {tau:.3f} CI [{lo:.3f}, {hi:.3f}]",
          flush=True)
    return g


def prng_checks():
    """Phase 5: K5 against its plain version, its many-tile times, then the
    GOF battery on the kernel's draws."""
    import torch
    from basicrta_torch.scripts import device_prng as dp

    dev = torch.device("cuda")
    require(torch.equal(dp.draw_kernel("uniform", 97, device=dev),
                        dp.draw_plain("uniform", 97, device=dev)),
            "K5 uniform bits differ from the plain version's")
    err = 0.0
    for kind, n, p, a in (("binom_lgamma", 5000, 0.47, 0.0),
                          ("binom_h4", 5000, 0.47, 0.0),
                          ("binom_h4", 16, 0.35, 0.0),
                          ("gamma", 0, 0, 0.0667), ("gamma", 0, 0, 3.7)):
        # three tiles in one launch: the battery's shape
        x = dp.draw_kernel(kind, 97, n, p, a, device=dev, tiles=3)
        y = dp.draw_plain(kind, 97, n, p, a, device=dev, tiles=3)
        same = torch.isclose(x, y, rtol=1e-4, atol=0).float().mean().item()
        require(same >= 0.999, f"K5 {kind} agrees in {same:.4f}")
        err = max(err, (x - y).abs().max().item())
        for t in range(3):
            require(torch.equal(x[t], dp.draw_kernel(
                kind, 97 + t * dp.SEED_STRIDE, n, p, a, device=dev)),
                f"K5 {kind}: tile {t} of a many-tile launch differs from "
                "the one-tile launch at its seed")
    times = dp.time_draws(dev)
    for kind, r in times.items():
        print(f"phase 5 K5 time {kind}: {json.dumps(r)}", flush=True)
    row = times["binom_h4"]
    # the last tile of each timed launch against the plain version
    last = 97 + (row["tiles"] - 1) * dp.SEED_STRIDE
    for kind, n, p, a in dp.TIMED:
        big = dp.draw_kernel(kind, 97, n, p, a, device=dev,
                             tiles=row["tiles"])
        y = dp.draw_plain(kind, last, n, p, a, device=dev)
        same = (torch.equal(big[-1], y) if kind == "uniform" else
                torch.isclose(big[-1], y, rtol=1e-4,
                              atol=0).float().mean().item() >= 0.999)
        require(same, f"K5 {kind}: tile {row['tiles'] - 1} of the timed "
                "launch differs from the plain version")
        del big
    # the counters of a stats build: the kernel's and one thread per
    # element's (K5 before its redesign), counted from the same draws
    for kind, layouts in dp.stats_report(row["tiles"], dev).items():
        print(f"phase 5 K5 stats {kind}: {json.dumps(layouts)}", flush=True)
    plain_ms = cuda_ms(lambda: dp.draw_plain(
        "binom_h4", 97, row["n"], row["p"], device=dev, tiles=row["tiles"]),
        1)
    dp.draw_kernel.launches = dp.draw_plain.calls = 0
    failures, not_run = dp.run_battery(
        dev, out=lambda line: print(f"phase 5 {line}", flush=True))
    launches = dp.draw_kernel.launches
    require(dp.draw_plain.calls == 0, "the battery drew plain versions")
    require(not failures, f"GOF battery failed: {failures}")
    print(f"phase 5 K5: uniform bits identical; max_abs_err {err}; binom "
          f"(5000, 0.47) x {row['tiles']} tiles {row['ms']:.4f} ms a launch "
          f"(one tile, the launch's time: {row['launch_ms']:.4f} ms), plain "
          f"{plain_ms:.2f} ms, {row['library']} {row['library_ms']:.4f} ms; "
          f"battery passed on {launches} kernel launches", flush=True)
    return dict(launches=launches, err=err, ms=row["ms"], plain_ms=plain_ms,
                library_ms=row["library_ms"], times=times)


def tree_checks(workload, production):
    """Phase 6: K4, the tree multinomial, in its three kernel forms against
    the plain tree on the card (K1-K3's pass rules, bitwise 1 + 1 block
    resume), exact totals and the moment check over 8 seeds on the
    kernel's draws, then the kernel A/B full vs tree_nat on protein-300's
    production layout (K4's path: the counts are read around it)."""
    import torch
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler import batch
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.sampler.kernels import (MixtureState, compute_tiers,
                                                dedup_times,
                                                init_mixture_params)
    from basicrta_torch.scripts import abench
    from basicrta_torch.scripts.workload import (discretize,
                                                 simulate_hyperexp)

    dev = torch.device("cuda")
    K = 15
    st0 = init_mixture_params(K, device=dev)
    cfg1 = GibbsConfig(ncomp=K, niter=2, g=1)
    cfg10 = GibbsConfig(ncomp=K, niter=10, g=10)
    report, err = {}, 0.0
    for label, bk in pow2_buckets(workload):
        B, V = bk.values.shape
        v = torch.tensor(bk.values, dtype=torch.float32, device=dev)
        c = torch.tensor(bk.counts, dtype=torch.float32, device=dev)
        tiers = cs.pad_tiers_to_rows(bk.tiers, V)
        st = MixtureState(st0.weights.repeat(B, 1), st0.rates.repeat(B, 1))
        ns, _ = cs.sweep_stats(7, st, v, c, K, tiers, tree=True)
        pn, _ = cs.sweep_stats_torch(7, st, v, c, K, tiers, tree=True)
        require(torch.equal(ns.sum(1), c.sum(1)), f"{label} K4 K1 totals")
        same = (ns == pn).float().mean().item()
        require(same >= 0.99, f"{label} K4 K1 N_k identical in {same:.4f}")
        s2, W, R = cs.segment(11, 0, st, v, c, cfg1, 2, tiers, tree=True)
        _, W2, R2 = cs.segment_torch(11, 0, st, v, c, cfg1, 2, tiers,
                                     tree=True)
        agree = _agree(W, R, W2, R2)
        require(agree >= 0.95, f"{label} K4 K2 lanes agreeing {agree:.4f}")
        s1, Wa, Ra = cs.segment(11, 0, st, v, c, cfg1, 1, tiers, tree=True)
        s1, Wb, Rb = cs.segment(11, 1, s1, v, c, cfg1, 1, tiers, tree=True)
        require(torch.equal(torch.cat([Wa, Wb], 1), W)
                and torch.equal(torch.cat([Ra, Rb], 1), R)
                and torch.equal(s1.weights, s2.weights), f"{label} K4 K2 "
                "1 + 1 blocks differ from 2 blocks")
        err = max(err, (ns - pn).abs().max().item())
        report[label] = dict(
            k1_same=same, k2_agree=agree, resume_bitwise=True,
            k1_ms=cuda_ms(lambda: cs.sweep_stats(7, st, v, c, K, tiers,
                                                 tree=True), 20),
            k1_plain_ms=cuda_ms(lambda: cs.sweep_stats_torch(
                7, st, v, c, K, tiers, tree=True), 2),
            k2_ms_10sweeps=cuda_ms(lambda: cs.segment(
                11, 0, st, v, c, cfg10, 1, tiers, tree=True), 20),
            k2_plain_ms_10sweeps=cuda_ms(lambda: cs.segment_torch(
                11, 0, st, v, c, cfg10, 1, tiers, tree=True), 1))
        print(f"phase 6 K4 {label} ({B} x {V}): {json.dumps(report[label])}",
              flush=True)
    for label, bk in packed_buckets(workload):
        vals, cnts, tiers, seg_id, slot, Bs = batch._kernel_layout(bk)
        v, c = torch.tensor(vals, device=dev), torch.tensor(cnts, device=dev)
        seg = None if seg_id is None else torch.tensor(seg_id, device=dev)
        rows = (torch.tensor(slot, device=dev) if slot is not None
                else torch.arange(bk.size, device=dev))
        st = MixtureState(st0.weights.repeat(Bs, 1), st0.rates.repeat(Bs, 1))
        args = (v, c)
        s2, W, R = cs.segment_packed(11, 0, st, *args, cfg1, 2, tiers,
                                     bk.pack, seg, tree=True)
        _, W2, R2 = cs.segment_packed_torch(11, 0, st, *args, cfg1, 2, tiers,
                                            bk.pack, seg, tree=True)
        agree = _agree(W, R, W2, R2, rows)
        require(agree >= 0.95, f"{label} K4 K3 lanes agreeing {agree:.4f}")
        err = max(err, (W - W2)[rows].abs().max().item(),
                  (R - R2)[rows].abs().max().item())
        s1, Wa, Ra = cs.segment_packed(11, 0, st, *args, cfg1, 1, tiers,
                                       bk.pack, seg, tree=True)
        s1, Wb, Rb = cs.segment_packed(11, 1, s1, *args, cfg1, 1, tiers,
                                       bk.pack, seg, tree=True)
        require(torch.equal(torch.cat([Wa, Wb], 1), W)
                and torch.equal(torch.cat([Ra, Rb], 1), R)
                and torch.equal(s1.weights, s2.weights), f"{label} K4 K3 "
                "1 + 1 blocks differ from 2 blocks")
        report[label] = dict(
            pack=bk.pack, Bph=v.shape[0], SL=v.shape[1] // 128,
            lanes=bk.size, tiers=tiers, k3_agree=agree, resume_bitwise=True,
            bytes=packed_bytes(v, Bs, K),
            k3_ms_10sweeps=cuda_ms(lambda: cs.segment_packed(
                11, 0, st, *args, cfg10, 1, tiers, bk.pack, seg, tree=True),
                20),
            k3_plain_ms_10sweeps=cuda_ms(lambda: cs.segment_packed_torch(
                11, 0, st, *args, cfg10, 1, tiers, bk.pack, seg, tree=True),
                1))
        print(f"phase 6 K4 {label}: {json.dumps(report[label])}", flush=True)

    # exact totals over 8 seeds and the moment check of tests/test_pallas.py
    # (3 lanes x 512 columns of 25,000-event hyperexponential times, K = 8)
    rng = np.random.default_rng(31)
    Bm, Vm, Km = 3, 512, 8
    vals, cnts = np.ones((Bm, Vm)), np.zeros((Bm, Vm))
    for i in range(Bm):
        x = discretize(simulate_hyperexp(25000, [0.7, 0.25, 0.05],
                                         [3.0, 0.3, 0.02], rng))
        vv, cc = dedup_times(x)
        order = np.argsort(-cc)
        vv, cc = vv[order][:Vm], cc[order][:Vm]
        vals[i, :len(vv)], cnts[i, :len(cc)] = vv, cc
    order, col_tiers = compute_tiers(cnts)
    vals = np.take_along_axis(vals, order, -1)
    cnts = np.take_along_axis(cnts, order, -1)
    stm = init_mixture_params(Km, device=dev)
    stm = MixtureState(stm.weights.repeat(Bm, 1), stm.rates.repeat(Bm, 1))
    v = torch.tensor(vals, dtype=torch.float32, device=dev)
    c = torch.tensor(cnts, dtype=torch.float32, device=dev)
    NS = []
    for seed in range(8):
        ns, ts = cs.sweep_stats(seed, stm, v, c, Km,
                                cs.pad_tiers_to_rows(col_tiers, Vm),
                                tree=True)
        require(torch.equal(ns.sum(1), c.sum(1)), "K4 exact N totals")
        NS.append(ns.cpu().numpy())
    w, r = stm.weights[0].cpu().numpy(), stm.rates[0].cpu().numpy()
    z = w * r * np.exp(-np.einsum("k,bv->bvk", r, vals))
    z = z / z.sum(-1, keepdims=True)
    expect = np.einsum("bv,bvk->bk", cnts, z)
    sd = np.sqrt(np.einsum("bv,bvk->bk", cnts, z * (1 - z)) / 8)
    zmax = float((np.abs(np.mean(NS, 0) - expect) / np.maximum(sd, 2.0)).max())
    require(zmax < 5.0, f"K4 moment z-score {zmax:.2f}")
    print(f"phase 6 K4 totals exact over 8 seeds; moment z-score max "
          f"{zmax:.3f} (< 5)", flush=True)

    # the kernel A/B: K4's path, the counts read around it
    counters = (cs.sweep_stats, cs.segment, cs.segment_packed)
    for f in counters:
        f.launches = f.tree_launches = 0
    ab = abench.run_ab({"mixed": production}, ["full", "tree_nat"],
                       AB_SWEEPS, AB_REPS, device=dev)
    torch.cuda.synchronize()
    tree_launches = sum(f.tree_launches for f in counters)
    require(tree_launches > 0, "K4 never launched on the A/B path")
    for line in abench.format_table(ab, True):
        print(f"phase 6 abench {line}", flush=True)
    pf, pt = ab["full"]["us_per_sweep"], ab["tree_nat"]["us_per_sweep"]
    print(f"phase 6 abench tree_nat / full per bucket: "
          f"{[round(b / a, 4) for a, b in zip(pf, pt)]}; aggregate "
          f"{ab['tree_nat']['agg'] / ab['full']['agg']:.4f}; K4 launches "
          f"{tree_launches}", flush=True)
    return dict(report=report, err=err, launches=tree_launches, ab=ab)


def roofline_checks(layouts, k1k2, k3, k5):
    """Phase 7: K6 against its plain version, the ceiling (K6's path, the
    counts read around it), vpu_transcendental_util of phase 3's
    production and pow2 layouts, and each kernel's bound."""
    import torch
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.scripts import roofline as rf

    dev = torch.device("cuda")
    out = torch.empty((rf.ROWS, rf.COLS), device=dev)
    err = 0.0
    # bench.py's scale sends every chain to 1.0 at its first step, so the
    # tile is also held at the check scale, where every step moves it
    for iters, scale in ((20, rf.CHECK_SCALE), (rf.ITERS, rf.SCALE)):
        rf.ceiling_tile(out, iters, scale)
        ref = rf.ceiling_tile_torch(iters, device=dev, scale=scale)
        torch.cuda.synchronize()
        require(torch.allclose(out, ref, rtol=1e-6, atol=0),
                f"K6 tile differs from its plain version ({iters} steps of "
                f"exp(x * {scale}))")
        err = max(err, (out - ref).abs().max().item())
        if scale == rf.CHECK_SCALE:
            rf.ceiling_tile(out, iters - 1, scale)
            require(not torch.allclose(out, ref, rtol=1e-5, atol=0),
                    "K6 tile does not move with its step count")
    peak = rf.sfu_peak(rf.max_sm_clock_mhz())
    rf.ceiling_tile.launches = 0
    ceiling = rf.transcendental_ceiling(dev)
    launches = rf.ceiling_tile.launches
    require(launches > 0, "K6 never launched")
    require(ceiling <= peak, f"K6 ceiling {ceiling:.6g} exp/s above the "
            f"SFU peak {peak:.6g}/s")
    ms = rf.ceiling_ops() / ceiling * 1e3
    plain_ms = rf.ceiling_ops() / rf.transcendental_ceiling_torch(dev) * 1e3
    x = torch.ones((rf.TILES, rf.ROWS, rf.COLS), device=dev)

    def exps():
        for _ in range(rf.ITERS):
            torch.exp(x)
    library_ms = cuda_ms(exps, 1)
    print(f"phase 7 K6: tile allclose rtol 1e-6 at 20 steps of exp(-x) and "
          f"{rf.ITERS} of exp(x * 1e-9) (max abs err {err}), 19 steps "
          f"differ; ceiling {ceiling:.6g} exp/s = {ceiling / peak:.4f} of "
          f"the SFU peak {peak:.6g}/s; {ms:.4f} ms a launch ({launches} "
          f"launches), plain {plain_ms:.3f} ms, {rf.ITERS} torch.exp calls "
          f"{library_ms:.3f} ms", flush=True)
    cfg = GibbsConfig(ncomp=15, niter=PROTEIN_SWEEPS)
    for name, (batches, agg) in layouts.items():
        util = rf.vpu_transcendental_util(batches, agg, cfg, ceiling)
        print(f"phase 7 vpu_transcendental_util {name}: {util:.6f} "
              f"({rf.transcendentals(batches, 15):,} transcendentals a "
              f"sweep at {agg:,.0f} lane-sweeps/s)", flush=True)

    K = 15
    f, m = k1k2["flagship"], k3["mixed"]
    # the reference layout's static counts, for comparison with the bounds
    sweep = cs.transcendentals_per_sweep(f["B"], f["V"], 1, (0, 0), K,
                                         phys=(f["V"] // 128, *f["tiers"]))
    packed = cs.transcendentals_per_sweep(
        m["lanes"], 0, m["pack"], (0, 0), K,
        phys=(m["SL"], *m["tiers"], m["Bph"]))
    # (work this run's data needs, bytes, static count); K1 draws no
    # conjugate; K2 adds its state: one thinned block + final
    work = {
        "sweep_stats": (f["work_k1"], f["bytes"], sweep),
        "segment": (10 * f["work"], f["bytes"] + 8 * f["B"] * K, 10 * sweep),
        "segment_packed": (10 * m["work"], m["bytes"], 10 * packed),
        "suff_stats_tree": (10 * m["work"], m["bytes"], 10 * packed),
        "transcendental_ceiling": (rf.ceiling_ops(), 4 * rf.ROWS * rf.COLS,
                                   rf.ceiling_ops()),
    }
    bounds = {}
    for name, (trans, nbytes, static) in work.items():
        t_ops, t_bytes = trans / peak, nbytes / rf.HBM_BYTES_PER_S
        bounds[name] = (1e3 * max(t_ops, t_bytes),
                        "operations" if t_ops >= t_bytes else "bytes")
        print(f"phase 7 bound {name}: {bounds[name][0]:.6g} ms "
              f"({bounds[name][1]}; {trans:,} transcendentals, {nbytes:,} "
              f"bytes; {1e3 * trans / ceiling:.6g} ms at the measured "
              f"ceiling; the reference layout's static count {static:,} "
              f"takes {1e3 * static / ceiling:.6g} ms there)", flush=True)
    # K5 at its timed size: the bytes written against the transcendentals
    # its draws need at one rejection round, over the measured ceiling
    for kind, r in k5["times"].items():
        b_ms, by, per_draw = rf.prng_bound(kind, r["draws"], ceiling, r["n"],
                                           r["p"], r["a"])
        if kind == "binom_h4":
            bounds["prng_draws"] = (b_ms, by)
        print(f"phase 7 bound prng_draws {kind}: {b_ms:.6g} ms ({by}; "
              f"{r['draws']:,} draws, {4 * r['draws']:,} bytes, "
              f"{per_draw:.4f} transcendentals a draw at 1 expected round, "
              f"the least); {r['ms']:.6g} ms a launch is "
              f"{100 * b_ms / r['ms']:.4g}% of the bound's rate; "
              f"{r['library']} {r['library_ms']:.6g} ms = "
              f"{r['library_ms'] / r['ms']:.3f}x the kernel", flush=True)
    return dict(ceiling=ceiling, peak=peak, launches=launches, err=err,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bounds=bounds)


def scan_breakdown(label, mc, u, B, frames=None):
    """Where a contact scan's time goes: a cold run of ``mc`` over the
    frames of ``u``, a warm run (frames/s, the host's prepare and collect
    seconds and the device's by CUDA events) and a run under
    torch.profiler (the device's busy share). Returns the warm run's
    records."""
    import torch
    n = u.n_frames if frames is None else len(frames)
    t0 = time.time()
    for _ in u.iter_batches(B, frames):
        pass
    decode = (time.time() - t0) / n
    mc.run(u.iter_batches(B, frames))                  # cold
    mc.time_device = True
    torch.cuda.synchronize()
    t0 = time.time()
    records = mc.run(u.iter_batches(B, frames))        # warm
    torch.cuda.synchronize()
    warm = time.time() - t0
    st = mc.stats
    mc.time_device = False
    wall, busy, acts, _ = _device_busy(
        lambda: mc.run(u.iter_batches(B, frames)))
    print(f"phase 8 {label}: {n} frames, {B} a batch, upload "
          f"{mc.cfg.upload_dtype}; warm {n / warm:.2f} frames/s "
          f"({warm:.3f} s); per frame: decode {decode:.5f} s (the reader "
          f"alone, main thread), host prepare {st['prepare_s'] / n:.5f} s "
          f"(prefetch thread), collect {st['collect_s'] / n:.5f} s (wait + "
          f"rows, main thread), device {st['device_s'] / n:.5f} s (CUDA "
          f"events); passes {json.dumps(st['passes'])}, "
          f"{st['retries_exact']} exact-fit retries, "
          f"{st['fallbacks_dense']} dense fallbacks, "
          f"{st['dense_overflows']} dense-transfer overflows, cap "
          f"{st['cap']}; profiled run {wall:.3f} s, device busy {busy:.3f} s "
          f"= {100 * busy / wall:.1f}%, {acts / n:.0f} device activities a "
          f"frame; {len(records)} rows", flush=True)
    return records, st


def contacts_file_to_tau(tmp):
    """Phase 8a: trajectory file -> contacts -> events -> tau through the
    CLI, on the membrane workload."""
    import re
    from basicrta_torch import cli
    from basicrta_torch.contacts.records import ContactEvents, ContactRecords
    from basicrta_torch.io.universe import Universe
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.scripts import contacts_reference as ref
    from basicrta_torch.scripts.workload import (make_membrane_frames,
                                                 write_membrane_files)

    work = os.path.join(tmp, "membrane")
    os.makedirs(work)
    t0 = time.time()
    batches, r1, r2, A1 = make_membrane_frames(n_frames=MEMBRANE_FRAMES,
                                               batch=100)
    made = time.time() - t0
    gro, xtc = write_membrane_files(work, batches, r1, r2)
    del batches
    print(f"phase 8a files: {MEMBRANE_FRAMES} frames x {len(r1) + len(r2)} "
          f"atoms made in {made:.2f} s, written in "
          f"{time.time() - t0 - made:.2f} s ({os.path.getsize(xtc) / 1e6:.1f}"
          f" MB of XTC)", flush=True)
    counters = (cs.segment, cs.segment_packed, cs.sweep_stats)
    plains = (cs.segment_torch, cs.segment_packed_torch,
              cs.sweep_stats_torch)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.time()
        with open("cli.log", "w") as log, contextlib.redirect_stdout(log), \
                contextlib.redirect_stderr(log):
            cli.main(["contacts", "--top", gro, "--traj", xtc, "--sel1",
                      "protein", "--sel2", "resname CHOL", "--cutoff",
                      "7.0"])
        contacts_s = time.time() - t0
        records = ContactRecords.load("contacts.npz")
        events = ContactEvents.load("contacts_7.0.npz")
        require(len(events) > 0 and len(records) > 0, "no contacts found")
        require(records.meta.ts == 0.1 or abs(records.meta.ts - 0.1) < 1e-6,
                f"inferred ts {records.meta.ts}")
        resids, counts = np.unique(events.sel1_resids, return_counts=True)
        top3 = resids[np.argsort(-counts)[:3]]
        t1 = time.time()
        with open("cli.log", "a") as log, contextlib.redirect_stdout(log), \
                contextlib.redirect_stderr(log):
            cli.main(["gibbs", "--contacts", "contacts_7.0.npz", "--niter",
                      str(PROTEIN_SWEEPS), "--resid",
                      *[str(r) for r in top3]])
        gibbs_s = time.time() - t1
        cli.main(["cluster", "--cutoff", "7.0", "--niter",
                  str(PROTEIN_SWEEPS)])
        wall = time.time() - t0
        taus = np.load("tausout.npy")
        labels = sorted(os.listdir("basicrta-7.0"))
    finally:
        os.chdir(cwd)
    launches = {f.__name__: f.launches for f in counters}
    launches.update({f.__name__: f.calls for f in plains})
    require(launches["segment"] + launches["segment_packed"] > 0,
            f"no sweep kernel launched: {launches}")
    require(all(launches[f.__name__] == 0 for f in plains),
            f"plain versions ran on the contacts -> tau path: {launches}")
    named = [d for d in labels if not d.startswith(".")]
    require(len(named) == 3 and all(re.match(r"^[A-WYZ]\d+$", d)
                                    for d in named),
            f"labels do not come from the topology: {named}")
    require(taus.shape == (3, 4) and np.isfinite(taus).all(),
            f"tausout {taus.shape}")
    require(np.all((0 <= taus[:, 2]) & (taus[:, 2] <= taus[:, 3])
                   & (taus[:, 1] > 0)), f"malformed tau table {taus}")

    # the CLI took the u16 wire format (an XTC input): the format's bound,
    # sqrt(3) grid steps, comes on top of the 1e-4 A
    u = Universe(gro, xtc)
    idx1, idx2 = u.select_atoms("protein"), u.select_atoms("resname CHOL")
    res = u.topology.resids
    sample = [0, 1, MEMBRANE_FRAMES // 2, MEMBRANE_FRAMES - 1]

    def read_frame(f):
        coords, _, box = u._read_frames([f])
        return coords[0], box[0]

    step = max(float(np.ptp(read_frame(f)[0], axis=0).max())
               for f in sample) / 65535.0
    atol = 1e-4 + 3 ** 0.5 * step
    shared, lone, err = ref.check_records(
        records, sample, read_frame, idx1, res[idx1], idx2, res[idx2], 10.0,
        atol=atol)
    require(shared > 0, "the sampled frames hold no contacts")
    print(f"phase 8a file -> tau: contacts {MEMBRANE_FRAMES} frames in "
          f"{contacts_s:.2f} s = {MEMBRANE_FRAMES / contacts_s:.1f} frames/s "
          f"end to end (u16 upload, dense kernel), {len(records)} rows, "
          f"{len(events)} events over {len(resids)} residues; rows of frames "
          f"{sample} against the host version: {shared} equal, {lone} within "
          f"{atol:.2g} A of the cutoff on one side only, max |d| {err:.3g} "
          f"A; gibbs on {named} ({counts[np.argsort(-counts)[:3]].tolist()} "
          f"events) {gibbs_s:.2f} s; wall {wall:.2f} s; tau "
          f"{taus[:, 1].round(3).tolist()} lo {taus[:, 2].round(3).tolist()} "
          f"hi {taus[:, 3].round(3).tolist()}; launches "
          f"{json.dumps(launches)}", flush=True)
    # where the dense scan's time goes, on the first 320 frames
    head = np.arange(min(320, MEMBRANE_FRAMES))
    from basicrta_torch.config import ContactConfig
    from basicrta_torch.contacts.mapper import MapContacts
    for upload in ("u16", "f32"):
        mc = MapContacts(idx1, res[idx1], idx2, res[idx2],
                         cfg=ContactConfig(upload_dtype=upload))
        _, st = scan_breakdown(f"membrane dense {upload} (14,800 atoms)", mc,
                               u, 32, head)
        require(st["passes"]["dense"] == -(-len(head) // 32)
                and st["passes"]["pruned"] == 0,
                f"the membrane takes the dense kernel: {st}")
    # phase 9 works on the residue with the most events
    return work, next(d for d in named if int(d[1:]) == top3[0])


def contacts_bilayer(tmp):
    """Phase 8b: the bilayer workload from an XTC file through
    Universe.iter_batches and MapContacts.run: the pruned path under both
    wire formats, against the dense kernel and the host version."""
    import torch
    from basicrta_torch.config import ContactConfig
    from basicrta_torch.contacts.mapper import MapContacts
    from basicrta_torch.io.universe import Universe
    from basicrta_torch.scripts import contacts_reference as ref
    from basicrta_torch.scripts.workload import (make_membrane_frames_large,
                                                 write_membrane_files)

    work = os.path.join(tmp, "bilayer")
    os.makedirs(work)
    batches, r1, r2, A1 = make_membrane_frames_large()
    n_frames = sum(len(b.frame_ids) for b in batches)
    gro, xtc = write_membrane_files(work, batches, r1, r2, "bilayer")
    del batches
    u = Universe(gro, xtc)
    idx1, idx2 = u.select_atoms("protein"), u.select_atoms("resname CHOL")
    res = u.topology.resids
    require(len(idx1) + len(idx2) == 101_400, "bilayer selections")
    B = 16

    def mapper(upload, **kw):
        return MapContacts(idx1, res[idx1], idx2, res[idx2],
                           cfg=ContactConfig(upload_dtype=upload,
                                             frames_per_batch=B, **kw))

    records = {}
    for upload in ("u16", "f32"):
        mc = mapper(upload)
        require(mc._prefilter_active(), "the bilayer is past the crossover")
        records[upload], st = scan_breakdown(
            f"bilayer pruned {upload} (101,400 atoms)", mc, u, B)
        require(st["passes"]["pruned"] >= n_frames // B
                and st["passes"]["dense"] + st["passes"]["dense_raw"] == 0
                and st["fallbacks_dense"] == 0,
                f"the pruned path was not taken throughout: {st}")

    # one batch through the dense kernel: the pruned rows must be its rows
    first = next(iter(u.iter_batches(B)))
    dense_mc = mapper("f32", prefilter=False)
    dense_mc.meta.ts = 0.1
    t0 = time.time()
    dense = dense_mc.run([first])
    torch.cuda.synchronize()
    dense_s = time.time() - t0
    require(dense_mc.stats["passes"]["dense"] == 1, "the dense path")
    pr = records["f32"]
    head = pr.frames < B
    require(np.array_equal(pr.frames[head], dense.frames)
            and np.array_equal(pr.sel1_resids[head], dense.sel1_resids)
            and np.array_equal(pr.sel2_resids[head], dense.sel2_resids),
            "pruned rows differ from the dense kernel's")
    diff = float(np.abs(pr.min_dist[head] - dense.min_dist).max())
    require(diff <= 1e-5, f"pruned min_dist differs from dense by {diff}")

    def read_frame(f):
        coords, _, box = u._read_frames([f])
        return coords[0], box[0]

    sample = [0, n_frames - 1]
    shared, lone, err = ref.check_records(
        pr, sample, read_frame, idx1, res[idx1], idx2, res[idx2], 10.0)
    step = max(float(np.ptp(read_frame(f)[0], axis=0).max())
               for f in sample) / 65535.0
    s16, l16, e16 = ref.check_records(
        records["u16"], sample, read_frame, idx1, res[idx1], idx2, res[idx2],
        10.0, atol=1e-4 + 3 ** 0.5 * step)
    require(shared > 0 and s16 > 0, "the sampled frames hold no contacts")
    print(f"phase 8b bilayer checks: pruned rows of the first {B} frames == "
          f"the dense kernel's ({int(head.sum())} rows, max |d| {diff:.3g} "
          f"A; the dense batch took {dense_s:.3f} s = "
          f"{dense_s / B:.4f} s/frame); frames {sample} against the host "
          f"version: f32 {shared} rows equal, {lone} at the cutoff, max |d| "
          f"{err:.3g} A (atol 1e-4); u16 {s16} equal, {l16} at the cutoff, "
          f"max |d| {e16:.3g} A (atol {1e-4 + 3 ** 0.5 * step:.2g})",
          flush=True)


def _read_dx_dir(paths):
    from basicrta_torch.io.dx import read_dx
    out = {}
    for p in paths:
        grid, origin, delta = read_dx(p)
        require(np.isfinite(grid).all() and grid.ndim == 3,
                f"{p} does not read back")
        out[os.path.basename(p)] = (grid, origin, delta)
    return out


def _grids_close(a, b, what):
    """rtol 1e-5 of the grid's largest value; returns the worst ratio."""
    worst = 0.0
    for name in b:
        x, y = a[name][0], b[name][0]
        require(x.shape == y.shape, f"{what}: {name} shapes")
        scale = max(float(np.abs(y).max()), 1e-30)
        err = float(np.abs(x - y).max()) / scale
        require(err <= 1e-5, f"{what}: {name} differs by {err:.3g} of "
                f"its largest value")
        worst = max(worst, err)
    return worst


def kinetics_file(work, label):
    """Phase 9a: the membrane run's residue with the most events through
    the CLI ``kinetics`` (xtc, then dcd), its files checked; then each
    step through the API on the card, timed, with the card's busy share
    during ``weighted_densities`` and the densities' mass checked."""
    from basicrta_torch import cli
    from basicrta_torch.io.native import DCDReader, XTCReader
    from basicrta_torch.kinetics.density import GridAccumulator
    from basicrta_torch.kinetics.mapper import MapKinetics
    from basicrta_torch.sampler.gibbs import Gibbs

    gpath = os.path.join(work, "basicrta-7.0", label,
                         f"gibbs_{PROTEIN_SWEEPS}.npz")
    argv = ["kinetics", "--gibbs", gpath, "--contacts", "contacts_7.0.npz",
            "--wdensity", "--comp-trajs", "--top_n", "100"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cli_s = {}
        for fmt in ("xtc", "dcd"):
            t0 = time.time()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(argv + ["--traj-format", fmt])
            cli_s[fmt] = time.time() - t0
            written = [ln.split()[-1] for ln in buf.getvalue().splitlines()
                       if ln.startswith("wrote ")]
            if fmt == "xtc":
                card = _read_dx_dir([w for w in written
                                     if w.endswith(".dx")])
                trajs = [w for w in written if not w.endswith(".dx")]
            else:
                trajs += [w for w in written if w.endswith(".dcd")]
        require(card, "kinetics wrote no density")
        g = Gibbs.load(gpath)
        mk = MapKinetics(g, "contacts_7.0.npz")
        table = mk.frame_table()
        assigned = np.argmax(table[:, 2:], axis=1)
        for path in trajs:
            n = (XTCReader(path) if path.endswith(".xtc")
                 else DCDReader(path)).nframes
            name = os.path.basename(path)
            if name.startswith("comp"):
                want = int((assigned == int(name[4:name.index("_")])).sum())
            else:
                want = min(100, len(table))
            require(n == want, f"{name}: {n} frames, its rows {want}")
        # the same rows' densities on the CPU (what --device cpu runs)
        cpu_paths = MapKinetics(g, "contacts_7.0.npz",
                                device="cpu").weighted_densities(top_n=100)
        cpu_err = _grids_close(card, _read_dx_dir(cpu_paths),
                               "card vs CPU densities")

        # each step on the card, timed
        steps = {}
        mk = MapKinetics(Gibbs.load(gpath), "contacts_7.0.npz")
        for name, fn in (("frame_table", mk.frame_table),
                         ("create_traj", lambda: mk.create_traj(top_n=100)),
                         ("write_component_trajs", mk.write_component_trajs)):
            t0 = time.time()
            fn()
            steps[name] = time.time() - t0
        box = {}

        def densities():
            box["paths"] = mk.weighted_densities()

        wall, busy, acts, _ = _device_busy(densities)
        steps["weighted_densities"] = wall
        alld = _read_dx_dir(box["paths"])

        # mass: grid plus spill == sum of frame weights x live atoms
        u = mk._open_universe()
        idx2 = u.select_atoms(mk.meta.sel2)
        res2 = u.topology.resids[idx2]
        idx1 = u.select_atoms(mk.meta.sel1)
        on_res = idx1[u.topology.resids[idx1] == int(label[1:])]
        acc = GridAccumulator(table.shape[1] - 2,
                              u.frame_positions([0])[0][on_res].mean(0))
        live = 0.0
        for lo in range(0, len(table), 512):
            rows = table[lo:lo + 512]
            pos, mask = mk._contact_positions(
                u, idx2, res2, rows[:, 0].astype(int),
                rows[:, 1].astype(int))
            acc.add(pos, rows[:, 2:], mask, 512)
            live += float((rows[:, 2:].sum(1) * mask.sum(1)).sum())
        spill = float(acc._spilled.sum().item())
        grids, _ = acc.finish()
        mass = float(grids.sum(dtype=np.float64)) + spill
        require(abs(mass - live) <= 1e-4 * live,
                f"grid + spill {mass} != weights x live atoms {live}")
        files_mass = sum(float(v[0].sum(dtype=np.float64))
                         * float(np.prod(v[2])) * len(table)
                         for v in alld.values())
        require(abs(files_mass + spill - live) <= 1e-4 * live,
                f"the written densities hold {files_mass} + spill {spill} "
                f"of {live}")
    finally:
        os.chdir(cwd)
    print(f"phase 9a kinetics {label}: {len(table)} frame-table rows, "
          f"{table.shape[1] - 2} components; CLI --top_n 100 xtc "
          f"{cli_s['xtc']:.2f} s, dcd {cli_s['dcd']:.2f} s; "
          f"{len(card) + len(alld)} .dx read back, {len(trajs)} "
          f"trajectories with their rows' frame counts; card vs CPU "
          f"densities within {cpu_err:.3g} of the largest value; steps (s) "
          f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}; "
          f"weighted_densities over all rows: card busy {busy:.4f} s of "
          f"{wall:.3f} s = {100 * busy / wall:.2f}%, {acts} device "
          f"activities; grid + spill {mass:.6g} = weights x live atoms "
          f"{live:.6g} (spill {spill:.6g})", flush=True)


def densities_full_size(g, work, label, tmp):
    """Phase 9b: the flagship residue (phase 4's chains, processed) given
    a seeded event table over membrane-2000, its frame table (the memmap
    branch) against a numpy expansion, and every row streamed through
    GridAccumulator on the card at the default grid."""
    import torch
    from basicrta_torch.contacts.records import ContactEvents, ContactMeta
    from basicrta_torch.io.universe import Universe
    from basicrta_torch.kinetics.density import (GridAccumulator, accumulate,
                                                 resolve_device)
    from basicrta_torch.kinetics.mapper import MapKinetics

    ts, chunk = 0.1, 50_000
    u = Universe(os.path.join(work, "membrane.gro"),
                 os.path.join(work, "membrane.xtc"))
    idx1, idx2 = u.select_atoms("protein"), u.select_atoms("resname CHOL")
    res = u.topology.resids
    resid = int(label[1:])
    t0 = time.time()
    frames = u.frame_positions(np.arange(MEMBRANE_FRAMES))
    decode_s = time.time() - t0
    center = frames[0][idx1[res[idx1] == resid]].mean(axis=0)
    lips = np.unique(res[idx2])
    lipid_pos = np.ascontiguousarray(
        frames[:, idx2].reshape(MEMBRANE_FRAMES, len(lips), -1, 3))
    del frames
    # the lipids that touch this residue in phase 8a (so their atoms land
    # in the grid around it, as a real residue's contacts do)
    ev8 = ContactEvents.load(os.path.join(work, "contacts_7.0.npz"))
    near = np.unique(ev8.sel2_resids[ev8.sel1_resids == resid])
    rng = np.random.default_rng(9)
    n = len(g.times)
    events = ContactEvents(
        np.zeros(n, np.int32), rng.choice(near, n).astype(np.int32),
        rng.integers(0, MEMBRANE_FRAMES, n) * ts, g.times,
        ContactMeta(ts=ts, cutoff=7.0))
    g.root = tmp
    mk = MapKinetics(g, events)
    t0 = time.time()
    table = mk.frame_table()
    table_s = time.time() - t0
    require(isinstance(table, np.memmap), "the memmap branch was not taken")
    # a numpy expansion of the same events
    first = np.rint(events.start_times / ts).astype(np.int64)
    nper = np.rint(events.durations / ts).astype(np.int64)
    starts = np.repeat(np.cumsum(nper) - nper, nper)
    require(len(table) == int(nper.sum()), "frame table rows")
    require(np.array_equal(table[:, 0], np.repeat(first, nper)
                           + np.arange(len(table)) - starts)
            and np.array_equal(table[:, 1],
                               np.repeat(events.sel2_resids, nper))
            and np.array_equal(table[:, 2:], np.repeat(
                g.pindicator_per_event(), nper, axis=0)),
            "the frame table differs from the numpy expansion")
    K = table.shape[1] - 2
    dev = resolve_device()            # the card

    def gather(lo, hi):
        rows = table[lo:hi]
        f = rows[:, 0].astype(np.int64) % MEMBRANE_FRAMES
        lp = np.searchsorted(lips, rows[:, 1].astype(np.int64))
        return lipid_pos[f, lp], np.asarray(rows[:, 2:], np.float32)

    def stream(n_rows, readback_each_chunk=False, timed=None):
        acc = GridAccumulator(K, center, device=dev)
        # the JAX package's design: a fresh chunk grid, read back and
        # added into an f32 host grid
        host = (np.zeros((K, int(np.prod(acc._nbins)) + 1), np.float32)
                if readback_each_chunk else None)
        for lo in range(0, n_rows, chunk):
            t0 = time.perf_counter()
            pos, w = gather(lo, min(lo + chunk, n_rows))
            t1 = time.perf_counter()
            pos_t = torch.from_numpy(pos).to(dev)
            w_t = torch.from_numpy(w).to(dev)
            t2 = time.perf_counter()
            if timed is not None:
                a, b = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                a.record()
            if readback_each_chunk:
                out = accumulate(pos_t, w_t, torch.ones(
                    pos_t.shape[:2], device=dev), acc._gmin, acc._delta,
                    acc._nbins)
                host += out.cpu().numpy()
            else:
                acc.add(pos_t, w_t, frame_chunk=chunk)
            if timed is not None:
                b.record()
                timed["events"].append((a, b))
                timed["gather_s"] += t1 - t0
                timed["upload_s"] += t2 - t1
        if readback_each_chunk:
            return host
        return acc

    n_rows = len(table)
    stream(n_rows)                                     # warm: allocator
    torch.cuda.synchronize()

    def one_readback():
        timed = {"events": [], "gather_s": 0.0, "upload_s": 0.0}
        t0 = time.time()
        acc = stream(n_rows, timed=timed)
        grids, _ = acc.finish()
        return time.time() - t0, timed, acc, grids

    def per_chunk_readback():
        t0 = time.time()
        host = stream(n_rows, readback_each_chunk=True)
        torch.cuda.synchronize()
        return time.time() - t0, host

    # the two designs in turns: this one, the JAX package's twice, this
    wall, timed, acc, grids = one_readback()
    parent_s = [per_chunk_readback()[0]]
    parent_s2, parent = per_chunk_readback()
    parent_s.append(parent_s2)
    wall2 = one_readback()[0]
    dev_ms = [a.elapsed_time(b) for a, b in timed["events"]]
    spill = acc._spilled.cpu().numpy()
    pwall, busy, acts, _ = _device_busy(lambda: stream(n_rows))
    nvox = int(np.prod(acc._nbins))
    perr = float(np.abs(parent[:, :nvox].reshape(grids.shape) - grids).max()
                 ) / max(float(np.abs(grids).max()), 1e-30)
    # two f32 summation orders over millions of rows: the hottest voxels
    # take ~1e6 additions each, so the orders part at ~1e-4 of the largest
    # value (the JAX package's f32 grids carry the same rounding)
    require(perr <= 1e-3, f"the per-chunk readback run differs by {perr}")
    # the plain version on the CPU, first 100,000 rows, against the card
    head = min(100_000, n_rows)
    pos, w = gather(0, head)
    plain = GridAccumulator(K, center, device="cpu")
    t0 = time.time()
    plain.add(pos, w, frame_chunk=chunk)
    plain_s = time.time() - t0
    card_head = stream(head)
    a = card_head.grids.cpu().numpy()
    b = plain.grids.numpy()
    herr = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
    require(herr <= 1e-5, f"the first chunks' grids differ from the plain "
            f"version by {herr:.3g} of the largest value")
    total = float(grids.sum(dtype=np.float64) + spill.sum())
    want = float(np.asarray(table[:, 2:]).sum(dtype=np.float64)
                 * lipid_pos.shape[2])
    require(abs(total - want) <= 1e-4 * want,
            f"grid + spill {total} != weights x atoms {want}")
    print(f"phase 9b densities at full size: {n_rows} frame-table rows "
          f"(memmap, {table_s:.2f} s, == the numpy expansion) of {n} "
          f"events, K = {K}, {lipid_pos.shape[2]} atoms a row, grid "
          f"{acc._nbins}; decode of {MEMBRANE_FRAMES} frames {decode_s:.2f} s "
          f"(held in memory); {n_rows / wall:,.0f} and {n_rows / wall2:,.0f} "
          f"rows/s ({wall:.3f} / {wall2:.3f} s in "
          f"{len(dev_ms)} chunks of {chunk}); device ms a chunk by CUDA "
          f"events: mean {np.mean(dev_ms):.4f}, min {min(dev_ms):.4f}, max "
          f"{max(dev_ms):.4f}, sum {sum(dev_ms):.2f}; host gather "
          f"{timed['gather_s']:.3f} s, upload {timed['upload_s']:.3f} s; "
          f"profiled run {pwall:.3f} s, device busy {busy:.4f} s = "
          f"{100 * busy / pwall:.2f}%, {acts} activities; one readback a "
          f"chunk (the JAX package's design, run between the two) "
          f"{parent_s[0]:.3f} / {parent_s[1]:.3f} s = "
          f"{n_rows / parent_s[0]:,.0f} / {n_rows / parent_s[1]:,.0f} rows/s "
          f"(equal within {perr:.2g} of the largest value); "
          f"plain CPU version on the first {head} rows {plain_s:.3f} s = "
          f"{head / plain_s:,.0f} rows/s, card within {herr:.3g} of the "
          f"largest value; spill {100 * spill.sum() / total:.3f}% of "
          f"{total:.6g}", flush=True)


SBC_SEEDS = (0, 1, 2)          # phase 10a: each SBC run at three seeds
COLLAPSED_BUDGET_S = 90        # phase 10d: the collapsed re-run's budget


def _sweep_launches():
    """The sweep kernels' launch counters and their plain versions' call
    counters, by name."""
    from basicrta_torch.sampler import cuda_sweep as cs
    out = {f.__name__: f.launches for f in (cs.segment, cs.segment_packed)}
    out.update({f.__name__: f.calls
                for f in (cs.segment_torch, cs.segment_packed_torch)})
    return out


def _reset_sweep_launches():
    from basicrta_torch.sampler import cuda_sweep as cs
    for f in (cs.segment, cs.segment_packed):
        f.launches = 0
    for f in (cs.segment_torch, cs.segment_packed_torch):
        f.calls = 0


def sbc_checks():
    """Phase 10a: simulation-based calibration on the card at the JAX
    script's defaults (M = 64, 2,000 events, K = 5, 20,000 sweeps, g 100,
    burn-in 4,000): the 'cuda' engine with uniform and with mixed replicate
    sizes (K2/K3, never a plain version) and the 'collapsed' engine, each
    at three seeds. A functional fails when its p is below 0.001 at any
    seed or below 0.01 at two."""
    import torch
    from basicrta_torch.scripts.sbc import run_sbc
    failed = []
    for tag, engine, mixed in (("cuda uniform", "cuda", False),
                               ("cuda mixed", "cuda", True),
                               ("collapsed uniform", "collapsed", False)):
        runs = []
        for seed in SBC_SEEDS:
            _reset_sweep_launches()
            t0 = time.time()
            pvals, _ = run_sbc(seed=seed, engine=engine, mixed_sizes=mixed,
                               progress=lambda line: print(
                                   f"phase 10a {tag} seed {seed}: {line}",
                                   flush=True))
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = _sweep_launches()
            if engine == "cuda":
                require(launches["segment"] + launches["segment_packed"] > 0,
                        f"SBC {tag}: K2/K3 never launched: {launches}")
                require(launches["segment_torch"]
                        + launches["segment_packed_torch"] == 0,
                        f"SBC {tag}: plain versions ran: {launches}")
            if mixed:
                require(launches["segment_packed"] > 0,
                        f"SBC {tag}: K3 never launched: {launches}")
            print(f"phase 10a {tag} seed {seed}: p {json.dumps(pvals)} in "
                  f"{secs:.2f} s; launches {json.dumps(launches)}",
                  flush=True)
            runs.append(pvals)
        for f in runs[0]:
            ps = [r[f] for r in runs]
            if min(ps) < 0.001 or sum(p < 0.01 for p in ps) >= 2:
                failed.append((tag, f, ps))
        print(f"phase 10a {tag}: "
              f"{'FAIL' if any(t == tag for t, _, _ in failed) else 'pass'}"
              f" under the three-seed rule", flush=True)
    require(not failed, f"SBC failed (engine, functional, p at seeds "
            f"{SBC_SEEDS}): {failed}")


def reference_cross_check():
    """Phase 10b: ``tests/test_equivalence.py``'s dataset and rules, the
    numpy reference sampler on the host against the 'cuda' and
    'collapsed' engines on the card: the dominant component's mean weight
    and rate within 8 standard errors + 1e-4, a two-sample KS on its rate
    with p > 1e-4, and overlapping 95% intervals of the slowest process's
    tau."""
    from scipy import stats

    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
    from basicrta_torch.sampler.batch import bucket_residues, run_batch
    from basicrta_torch.scripts.reference_sampler import (
        numpy_reference_sampler)
    from basicrta_torch.scripts.validate import dominant, slow_taus

    x = discretize_times(simulate_hyperexp(
        12000, [0.8, 0.17, 0.03], [3.0, 0.25, 0.02],
        np.random.default_rng(99)), 0.1)
    cfg = GibbsConfig(ncomp=5, niter=3000, g=10, burnin=1000, seed=11)
    burn, wcut = cfg.burnin_samples, cfg.wcutoff(len(x))
    t0 = time.time()
    Wn, Rn = numpy_reference_sampler(x, cfg, seed=1)
    print(f"phase 10b numpy reference: {len(x)} events, {cfg.niter} sweeps "
          f"in {time.time() - t0:.2f} s", flush=True)
    w_ref, r_ref = dominant(Wn, Rn, burn)
    ci_ref = np.percentile(slow_taus(Wn, Rn, burn, wcut), [2.5, 97.5])
    batch = bucket_residues({"R": x})[0]
    for engine in ("cuda", "collapsed"):
        t0 = time.time()
        res = run_batch(batch, cfg, engine=engine)
        secs = time.time() - t0
        W, R = res.mcweights[0], res.mcrates[0]
        w_our, r_our = dominant(W, R, burn)
        gaps = []
        for ref, our in ((w_ref, w_our), (r_ref, r_our)):
            se = ref.std() * np.sqrt(2.0 / len(ref))
            gaps.append((abs(ref.mean() - our.mean()), 8 * se + 1e-4))
        ks = stats.ks_2samp(r_ref, r_our).pvalue
        ci = np.percentile(slow_taus(W, R, burn, wcut), [2.5, 97.5])
        overlap = ci[0] <= ci_ref[1] and ci_ref[0] <= ci[1]
        print(f"phase 10b {engine}: {secs:.2f} s; dominant weight ref "
              f"{w_ref.mean():.5f} ours {w_our.mean():.5f} (|d| "
              f"{gaps[0][0]:.2e} < {gaps[0][1]:.2e}), rate ref "
              f"{r_ref.mean():.5f} ours {r_our.mean():.5f} (|d| "
              f"{gaps[1][0]:.2e} < {gaps[1][1]:.2e}); KS rate p {ks:.4g}; "
              f"slowest tau CI ref [{ci_ref[0]:.2f}, {ci_ref[1]:.2f}] ours "
              f"[{ci[0]:.2f}, {ci[1]:.2f}]", flush=True)
        require(all(d < lim for d, lim in gaps),
                f"{engine}: dominant component off the reference: {gaps}")
        require(ks > 1e-4, f"{engine}: KS p {ks}")
        require(overlap, f"{engine}: slowest tau CIs apart: {ci} {ci_ref}")


def reference_chains(workload, flagship, tmp):
    """Phase 10c: ``Gibbs.run(mode='collapsed')`` on the flagship residue
    at 11,000 sweeps and ``mode='dense'`` at 1,100, each with its us a
    sweep, and kernels a sweep and the card's busy share by
    torch.profiler over 100 sweeps; tau and CI finite, and the collapsed
    CI must overlap phase 4's flagship CI (the 'cuda' engine, 110,000
    sweeps). Returns the collapsed engine's seconds a sweep."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler.gibbs import Gibbs
    from basicrta_torch.sampler.kernels import (compute_tiers, dedup_times,
                                                run_chains)

    x = workload[0]
    v, c = dedup_times(x)
    order, tiers = compute_tiers(c)
    rate = {}
    # burn-in as the CLI sets it (a tenth); the dense run thins every 10
    for mode, cfg in (("collapsed", GibbsConfig(niter=11_000, burnin=1_100)),
                      ("dense", GibbsConfig(niter=1_100, g=10, burnin=110))):
        g = Gibbs(x, residue="R0", cutoff=7.0, cfg=cfg, root=tmp)
        torch.cuda.synchronize()
        t0 = time.time()
        g.run(mode=mode, save=False)
        secs = time.time() - t0
        rate[mode] = secs / cfg.niter
        g.process_gibbs(save=False)
        lo, tau, hi = g.estimate_tau()
        require(np.isfinite([lo, tau, hi]).all() and lo <= hi,
                f"{mode}: tau {tau} CI [{lo}, {hi}]")
        data = v[order] if mode == "collapsed" else x
        aux = c[order] if mode == "collapsed" else None
        dev = [None if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=g.device) for a in (data, aux)]
        one = GibbsConfig(niter=100, g=100)
        gen = g._generator(0)

        def hundred():
            run_chains(gen, dev[0], dev[1], one, mode,
                       tiers=tiers if mode == "collapsed" else None)

        wall, busy, acts, kernels = _device_busy(hundred)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            hundred()
            torch.cuda.synchronize()
        top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
        print(f"phase 10c {mode}: {len(x)} events (V = {len(v)}, tiers "
              f"{tiers}), K = {cfg.ncomp}, {cfg.niter} sweeps in {secs:.2f} "
              f"s = {1e6 * rate[mode]:.1f} us a sweep; profiled 100 sweeps: "
              f"{kernels / 100:.1f} kernels a sweep ({acts / 100:.1f} device "
              f"activities), the card busy {1e4 * busy:.1f} us a sweep = "
              f"{1e4 * busy / (1e6 * rate[mode]):.1%} of the unprofiled "
              f"sweep ({100 * busy / wall:.1f}% of {wall:.3f} s under the "
              f"profiler); most device time: " + "; ".join(
                  f"{e.key[:60]} {e.device_time_total / 100:.1f} us a sweep "
                  f"x{e.count / 100:.0f}" for e in top[:3])
              + f"; tau {tau:.3f} CI [{lo:.3f}, {hi:.3f}]", flush=True)
        if mode == "collapsed":
            flo, _, fhi = flagship.tau
            require(lo <= fhi and flo <= hi,
                    f"collapsed CI [{lo}, {hi}] misses the flagship's "
                    f"[{flo}, {fhi}]")
    return rate["collapsed"]


def protein_full_length(collapsed_s_per_sweep):
    """Phase 10d: the port's ``validate.py`` part 3 at full length: 50
    residues x 2 chains at ``GibbsConfig()`` (110,000 sweeps) on the 'cuda'
    engine, then the batched post-processing; finite tau, split-R-hat.
    The 4 residues of highest R-hat run again on the 'collapsed' engine at
    110,000 sweeps, or at the largest multiple of 10,000 that fits the
    budget at the bucket's own rate (10c's is printed beside it); both
    engines' R-hat side by side."""
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler.batch import bucket_residues, run_batch
    from basicrta_torch.sampler.gibbs import Gibbs
    from basicrta_torch.scripts.validate import full_protein, protein_times

    times = protein_times(50)
    cfg = GibbsConfig()
    _reset_sweep_launches()
    gibbs, t_samp, t_fin = full_protein(times, cfg, n_chains=2,
                                        engine="cuda")
    launches = _sweep_launches()
    require(launches["segment"] + launches["segment_packed"] > 0
            and launches["segment_torch"] + launches["segment_packed_torch"]
            == 0, f"10d launches {launches}")
    taus = np.asarray([g.tau for g in gibbs.values()], np.float64)
    require(np.isfinite(taus).all(), "10d: non-finite tau")
    rhat = {lab: g.diagnostics()["max_rhat"] for lab, g in gibbs.items()}
    r = np.asarray(list(rhat.values()))
    print(f"phase 10d cuda: {len(times)} residues x 2 chains x {cfg.niter} "
          f"sweeps: sampling {t_samp:.2f} s, post-processing {t_fin:.2f} s; "
          f"finite tau {int(np.isfinite(taus).all(1).sum())}/{len(taus)}; "
          f"split-R-hat median {np.nanmedian(r):.4f}, 90th percentile "
          f"{np.nanpercentile(r, 90):.4f}, > 1.1: {int((r > 1.1).sum())}, "
          f"max {np.nanmax(r):.4f}; launches {json.dumps(launches)}",
          flush=True)

    # the 4 residues of highest R-hat x 2 chains as one bucket: the
    # collapsed engine's time a sweep is its launches', whatever the lanes
    top = sorted(rhat, key=lambda lab: -np.nan_to_num(rhat[lab], nan=9.0))[:4]
    lanes = {f"{lab}#{ch}": times[lab] for lab in top for ch in range(2)}
    width = max(len(np.unique(t)) for t in lanes.values())
    (bucket,) = bucket_residues(lanes, floor=-(-width // 128) * 128)
    # the bucket's own rate, from 1,000 sweeps, next to 10c's
    t0 = time.time()
    run_batch(bucket, GibbsConfig(niter=1000), engine="collapsed")
    probe = (time.time() - t0) / 1000
    sweeps = cfg.niter
    if probe * sweeps > COLLAPSED_BUDGET_S:
        sweeps = max(10_000, int(COLLAPSED_BUDGET_S / probe)
                     // 10_000 * 10_000)
    cfg_c = GibbsConfig(niter=sweeps, burnin=min(10_000, sweeps // 10))
    t0 = time.time()
    res = run_batch(bucket, cfg_c, engine="collapsed")
    secs = time.time() - t0
    rhat_c = {}
    for lab in top:
        rows = [res.names.index(f"{lab}#{ch}") for ch in range(2)]
        g = Gibbs(times[lab], residue=lab, cutoff=7.0, cfg=cfg_c)
        g.mcweights, g.mcrates = res.mcweights[rows], res.mcrates[rows]
        rhat_c[lab] = g.diagnostics()["max_rhat"]
    print(f"phase 10d collapsed: the 4 highest-R-hat residues x 2 chains as "
          f"one bucket (V = {bucket.values.shape[1]}, tiers {bucket.tiers}) "
          f"at {sweeps} sweeps (110,000 would take "
          f"{collapsed_s_per_sweep * cfg.niter:.0f} s at 10c's rate, "
          f"{probe * cfg.niter:.0f} s at the bucket's own from 1,000 sweeps; "
          f"budget {COLLAPSED_BUDGET_S} s): {secs:.2f} s = "
          f"{1e6 * secs / sweeps:.1f} us a sweep; split-R-hat cuda -> "
          f"collapsed " + ", ".join(
              f"{lab} ({len(times[lab])} events) {rhat[lab]:.4f} -> "
              f"{rhat_c[lab]:.4f}" for lab in top), flush=True)


def reference_phase(workload, flagship, tmp):
    """Phase 10: 10a-10d, each with its seconds."""
    t0 = time.time()
    sbc_checks()
    t1 = time.time()
    reference_cross_check()
    t2 = time.time()
    rate = reference_chains(workload, flagship, tmp)
    t3 = time.time()
    protein_full_length(rate)
    print(f"phase 10 seconds: 10a {t1 - t0:.1f}, 10b {t2 - t1:.1f}, 10c "
          f"{t3 - t2:.1f}, 10d {time.time() - t3:.1f}", flush=True)

EVENT_SHARD_SWEEPS = 2000      # phase 11b
SHARD_FRAMES = 256             # phase 11c


def _shard_devices():
    """(visible cards, phase 11's lane shards): every card when more than
    one is visible, else two shards on the one card."""
    import torch
    from basicrta_torch.parallel.mesh import local_devices
    cards = local_devices()
    if len(cards) > 1:
        print(f"phase 11 devices: {len(cards)} cards visible, the shards "
              f"run over {[str(d) for d in cards]}", flush=True)
        return cards, cards
    print(f"phase 11 devices: only one card was visible "
          f"({torch.cuda.get_device_name(0)}); two shards share it, so its "
          f"times are those of one card, not a speed-up", flush=True)
    return cards, cards * 2


def sharded_protein(workload, tmp, devices):
    """Phase 11a: protein-300 x 2 chains at K = 15 and 10,000 sweeps on the
    production layout: ``ParallelGibbs.run(n_devices=0)`` against the
    unsharded run, then ``run_residues`` on a mesh of ``devices`` with
    sharded post-processing; K3 on each shard of the largest mixed bucket
    against its plain version at that shard's seed."""
    import zlib

    import torch
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.contacts.records import ContactEvents, ContactMeta
    from basicrta_torch.parallel.mesh import (lane_sharding, make_mesh,
                                              split_rows)
    from basicrta_torch.protein.driver import ParallelGibbs, finish_batch
    from basicrta_torch.sampler import batch
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.sampler.gibbs import Gibbs
    from basicrta_torch.sampler.kernels import (MixtureState,
                                                init_mixture_params)

    cfg = GibbsConfig(niter=PROTEIN_SWEEPS, burnin=PROTEIN_SWEEPS // 10,
                      n_chains=2)
    resids = np.concatenate([np.full(len(t), i + 1, np.int32)
                             for i, t in workload.items()])
    durations = np.concatenate(list(workload.values()))
    events = ContactEvents(resids, np.zeros_like(resids),
                           np.zeros_like(durations), durations,
                           ContactMeta(cutoff=7.0))
    runs, secs = {}, {}
    for n in (None, 0):
        _reset_sweep_launches()
        t0 = time.time()
        runs[n] = ParallelGibbs(events, cfg, root=os.path.join(
            tmp, f"devices_{n}")).run(engine="cuda", n_devices=n)
        torch.cuda.synchronize()
        secs[n] = time.time() - t0
        launches = _sweep_launches()
        require(launches["segment_packed"] > 0
                and launches["segment_torch"] == 0
                and launches["segment_packed_torch"] == 0,
                f"n_devices={n}: the launches were {launches}")
    require(sorted(runs[0]) == sorted(runs[None])
            and len(runs[0]) == len(workload), "residue sets differ")
    for lab, g in runs[None].items():
        h = runs[0][lab]
        require(np.array_equal(g.mcweights, h.mcweights)
                and np.array_equal(g.mcrates, h.mcrates),
                f"{lab}: n_devices=0 samples differ from the unsharded run")
        require(g.tau == h.tau, f"{lab}: tau {h.tau} against {g.tau}")
    print(f"phase 11a n_devices=0 == unsharded: {len(runs[0])} residues, "
          f"samples and tau bitwise; ParallelGibbs.run {secs[None]:.2f} s "
          f"unsharded, {secs[0]:.2f} s with n_devices=0", flush=True)

    # the lanes over the mesh: run_residues, then sharded post-processing;
    # run_batches is timed inside it (sampling alone) and its layout kept
    sh = lane_sharding(make_mesh(n_lanes=len(devices), devices=devices))
    seen = {}
    original = batch.run_batches

    def timed_run_batches(layout, *a, **k):
        t0 = time.time()
        out = original(layout, *a, **k)
        seen["sampling_s"] = time.time() - t0
        seen["layout"] = layout
        return out

    times = {f"X{i + 1}": t for i, t in workload.items()}
    batch.run_batches = timed_run_batches
    _reset_sweep_launches()
    try:
        t0 = time.time()
        samples = batch.run_residues(times, cfg, n_chains=2, engine="cuda",
                                     sharding=sh)
        run_s = time.time() - t0
    finally:
        batch.run_batches = original
    launches = _sweep_launches()
    require(launches["segment_packed"] > 0
            and launches["segment_torch"] == 0
            and launches["segment_packed_torch"] == 0,
            f"sharded run: the launches were {launches}")
    gibbs = {}
    for lab, (W, R) in samples.items():
        g = Gibbs(times[lab], residue=lab, cutoff=7.0, cfg=cfg, root=tmp)
        g.mcweights, g.mcrates = W, R
        gibbs[lab] = g
    t0 = time.time()
    finish_batch(gibbs, save=False, sharding=sh)
    post_s = time.time() - t0
    taus = np.array([g.tau for g in gibbs.values()])     # (lo, tau, hi)
    require(len(taus) == len(workload) and np.isfinite(taus).all(),
            "sharded run: a tau is not finite")
    require(np.all((0 <= taus[:, 0]) & (taus[:, 0] <= taus[:, 2])),
            "sharded run: a CI with lo < 0 or lo > hi")
    layout = seen["layout"]
    t0 = time.time()
    batch.run_batches(layout, cfg, engine="cuda")
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    t0 = time.time()
    batch.run_batches(layout, cfg, engine="cuda", sharding=sh)
    torch.cuda.synchronize()
    shard_s = time.time() - t0
    lane_sweeps = 2 * len(workload) * PROTEIN_SWEEPS
    print(f"phase 11a sharded: {len(devices)} lane shards on "
          f"{[str(d) for d in devices]}; run_residues {run_s:.2f} s "
          f"(sampling {seen['sampling_s']:.2f} s with checkpoints off), "
          f"sharded post-processing {post_s:.2f} s, {len(taus)} tau finite "
          f"with 0 <= lo <= hi; launches {json.dumps(launches)}; sampling "
          f"alone (run_batches, {PROTEIN_SWEEPS} sweeps) unsharded "
          f"{plain_s:.3f} s = {lane_sweeps / plain_s:,.0f} lane-sweeps/s, "
          f"{len(devices)} shards {shard_s:.3f} s = "
          f"{lane_sweeps / shard_s:,.0f} lane-sweeps/s", flush=True)

    # K3 on each shard of the largest mixed bucket, at the shard's seed
    mixed = max((b for b in layout if b.bounds is not None),
                key=lambda b: len(b.bounds))
    n = len(devices)
    vals, cnts, tiers, seg_id, slot, Bs = batch._kernel_layout(mixed, n)
    salt = zlib.crc32(",".join(mixed.names).encode()) & 0x7FFFFFFF
    seed0 = (cfg.seed ^ salt) & 0x7FFFFFFF
    cfg2 = GibbsConfig(ncomp=cfg.ncomp, niter=2, g=1)
    st0 = init_mixture_params(cfg.ncomp)
    report = []
    for s, (vr, sr) in enumerate(zip(split_rows(len(vals), n),
                                     split_rows(Bs, n))):
        dev = devices[s]
        seed = cs._int32(seed0 + s * batch._SHARD_SEED_STRIDE)
        rows_s = sr.stop - sr.start
        st = MixtureState(st0.weights.repeat(rows_s, 1).to(dev),
                          st0.rates.repeat(rows_s, 1).to(dev))
        args = (torch.tensor(vals[vr], device=dev),
                torch.tensor(cnts[vr], device=dev))
        seg = torch.tensor(seg_id[vr], device=dev)
        _, W, R = cs.segment_packed(seed, 0, st, *args, cfg2, 2, tiers,
                                    mixed.pack, seg)
        _, W2, R2 = cs.segment_packed_torch(seed, 0, st, *args, cfg2, 2,
                                            tiers, mixed.pack, seg)
        mine = torch.tensor(slot[(slot >= sr.start) & (slot < sr.stop)]
                            - sr.start, device=dev)
        agree = _agree(W, R, W2, R2, mine)
        require(agree >= 0.95, f"shard {s}: K3 lanes agreeing {agree:.4f}")
        report.append(dict(shard=s, seed=seed, phys_lanes=vr.stop - vr.start,
                           members=len(mine), k3_agree=agree))
    print(f"phase 11a K3 per shard of the largest mixed bucket (pack "
          f"{mixed.pack}, {len(mixed.bounds)} physical lanes padded to "
          f"{len(vals)}): {json.dumps(report)}", flush=True)


def _dominant(res, burn):
    out = []
    for W, R in zip(res.mcweights, res.mcrates):
        k = W[burn:].mean(0).argmax()
        out.append((float(W[burn:, k].mean()), float(R[burn:, k].mean())))
    return out


def event_shards(cards):
    """Phase 11b: 4 lanes of one ~5,000-event residue on the collapsed
    engine over a (2 lanes, 2 events) mesh of ``cards`` (round robin),
    held to the unsharded run in law: the dominant component's posterior
    mean weight within 5% and its rate within 8%, each averaged over the
    4 chains (one chain of a K = 4 mixture can split its dominant
    component for a while, in either run)."""
    import torch
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.parallel.mesh import event_sharding, make_mesh
    from basicrta_torch.sampler import batch
    from basicrta_torch.scripts.workload import discretize, simulate_hyperexp

    devices = [cards[i % len(cards)] for i in range(4)]
    x = discretize(simulate_hyperexp(5000, [0.8, 0.2], [2.0, 0.1],
                                     np.random.default_rng(9)))
    (b,) = batch.bucket_residues({f"L{i}": x for i in range(4)}, floor=256)
    cfg = GibbsConfig(ncomp=4, niter=EVENT_SHARD_SWEEPS, g=10,
                      burnin=EVENT_SHARD_SWEEPS // 4, seed=9)
    mesh = make_mesh(n_lanes=2, n_events=2, devices=devices)
    t0 = time.time()
    res = batch.run_batch(b, cfg, engine="collapsed",
                          sharding=event_sharding(mesh))
    torch.cuda.synchronize()
    sharded_s = time.time() - t0
    t0 = time.time()
    ref = batch.run_batch(b, cfg, engine="collapsed")
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    got, want = (_dominant(r, cfg.burnin_samples) for r in (res, ref))
    (w, r), (wr, rr) = np.mean(got, axis=0), np.mean(want, axis=0)
    require(abs(w - wr) <= 0.05 * wr and abs(r - rr) <= 0.08 * rr,
            f"event-sharded dominant (w, rate) {(w, r)} against {(wr, rr)}")
    print(f"phase 11b event shards: 4 lanes x {len(x)} events (V = "
          f"{b.values.shape[1]}, {len(np.unique(x))} unique), "
          f"{EVENT_SHARD_SWEEPS} collapsed sweeps; mesh 2 lanes x 2 events "
          f"on {[str(d) for d in devices]} {sharded_s:.2f} s "
          f"({1e6 * sharded_s / EVENT_SHARD_SWEEPS:.1f} us a sweep), "
          f"unsharded {plain_s:.2f} s "
          f"({1e6 * plain_s / EVENT_SHARD_SWEEPS:.1f} us); dominant (w, "
          f"rate) sharded {json.dumps(got)} unsharded {json.dumps(want)}",
          flush=True)


def frame_shards(tmp, devices):
    """Phase 11c: membrane frames through MapContacts with their frames
    split over ``devices`` against the unsharded scan, then the CLI
    ``contacts --ndevices 0`` against no flag."""
    from basicrta_torch import cli
    from basicrta_torch.config import ContactConfig
    from basicrta_torch.contacts.mapper import MapContacts
    from basicrta_torch.contacts.records import ContactRecords
    from basicrta_torch.io.universe import Universe
    from basicrta_torch.scripts.workload import (make_membrane_frames,
                                                 write_membrane_files)

    work = os.path.join(tmp, "frame_shards")
    os.makedirs(work)
    batches, r1, r2, A1 = make_membrane_frames(n_frames=SHARD_FRAMES,
                                               batch=64)
    gro, xtc = write_membrane_files(work, batches, r1, r2)
    del batches
    u = Universe(gro, xtc)
    idx1, idx2 = u.select_atoms("protein"), u.select_atoms("resname CHOL")
    res = u.topology.resids
    B = 31                    # odd: the shards pad the frame axis
    recs, secs = {}, {}
    for name, devs in (("unsharded", None), ("sharded", devices)):
        mc = MapContacts(idx1, res[idx1], idx2, res[idx2],
                         cfg=ContactConfig(upload_dtype="f32",
                                           frames_per_batch=B),
                         devices=devs)
        t0 = time.time()
        recs[name] = mc.run(u.iter_batches(B))
        secs[name] = time.time() - t0
    a, b = recs["sharded"], recs["unsharded"]
    require(len(b) > 0, "no contacts found")
    for f in ("frames", "sel1_resids", "sel2_resids", "times", "min_dist"):
        require(np.array_equal(getattr(a, f), getattr(b, f)),
                f"frame-sharded {f} differ from the unsharded scan")
    out = {}
    cwd = os.getcwd()
    try:
        for flag in ([], ["--ndevices", "0"]):
            d = os.path.join(work, "cli_" + ("".join(flag) or "plain"))
            os.makedirs(d)
            os.chdir(d)
            with open("cli.log", "w") as log, \
                    contextlib.redirect_stdout(log), \
                    contextlib.redirect_stderr(log):
                cli.main(["contacts", "--top", gro, "--traj", xtc, "--sel1",
                          "protein", "--sel2", "resname CHOL", "--cutoff",
                          "7.0"])
            out[bool(flag)] = ContactRecords.load("contacts.npz")
    finally:
        os.chdir(cwd)
    for f in ("frames", "sel1_resids", "sel2_resids", "times", "min_dist"):
        require(np.array_equal(getattr(out[True], f),
                               getattr(out[False], f)),
                f"contacts --ndevices 0: {f} differ from no flag")
    print(f"phase 11c frame shards: {SHARD_FRAMES} membrane frames in "
          f"batches of {B}, {len(b)} rows; {len(devices)} shards on "
          f"{[str(d) for d in devices]} == unsharded ({secs['sharded']:.2f} "
          f"s against {secs['unsharded']:.2f} s); CLI contacts --ndevices 0 "
          f"== no flag ({len(out[True])} rows)", flush=True)


def density_shards(devices):
    """Phase 11d: GridAccumulator with its frames split over ``devices``
    against one device, at rtol 1e-5 of each grid's largest voxel."""
    import torch
    from basicrta_torch.kinetics.density import GridAccumulator
    from basicrta_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(13)
    F, A, K = 100_001, 50, 7
    pos = rng.normal(0.0, 6.0, (F, A, 3)).astype(np.float32)
    w = rng.dirichlet(np.ones(K), F).astype(np.float32)
    mask = (rng.random((F, A)) < 0.9).astype(np.float32)
    accs, secs = {}, {}
    for name, mesh in (("one device", None), ("sharded", make_mesh(
            n_lanes=len(devices), devices=devices))):
        acc = GridAccumulator(K, [0.0, 0.0, 0.0], mesh=mesh)
        t0 = time.time()
        acc.add(pos, w, mask, frame_chunk=50_000)
        accs[name] = acc.finish()[0]
        torch.cuda.synchronize()
        secs[name] = time.time() - t0
    a, b = accs["sharded"], accs["one device"]
    gap = np.abs(a - b).max(axis=(1, 2, 3))
    peak = np.abs(b).max(axis=(1, 2, 3))
    require(b.sum() > 0 and (gap <= 1e-5 * peak).all(),
            f"sharded grids differ: {gap} against {peak}")
    print(f"phase 11d densities: {F} rows x {A} atoms, K = {K}, 40 A grid; "
          f"{len(devices)} shards == one device (largest gap "
          f"{float((gap / peak).max()):.3g} of a grid's peak); "
          f"{secs['sharded']:.2f} s sharded, {secs['one device']:.2f} s on "
          f"one device (host upload included)", flush=True)


def sharded_phase(workload, tmp):
    """Phase 11: 11a-11d, each with its seconds."""
    cards, devices = _shard_devices()
    t0 = time.time()
    sharded_protein(workload, tmp, devices)
    t1 = time.time()
    event_shards(cards)
    t2 = time.time()
    frame_shards(tmp, devices)
    t3 = time.time()
    density_shards(devices)
    print(f"phase 11 seconds: 11a {t1 - t0:.1f}, 11b {t2 - t1:.1f}, 11c "
          f"{t3 - t2:.1f}, 11d {time.time() - t3:.1f}", flush=True)


# ------------------------------------------------------------- phase 12
def _quiet_cli(argv, logpath):
    """Run one CLI command with its output appended to ``logpath``."""
    from basicrta_torch import cli
    with open(logpath, "a") as log, contextlib.redirect_stdout(log), \
            contextlib.redirect_stderr(log):
        cli.main(argv)


def _stand_in_modules():
    """Throwaway ``basicrta`` / ``MDAnalysis`` modules to write pickles
    with the reference package's class paths; removed again by
    :func:`_drop_stand_ins` so that loading must work without them."""
    import types
    gibbs_mod = types.ModuleType("basicrta.gibbs")
    groups = types.ModuleType("MDAnalysis.core.groups")

    class Gibbs:
        pass

    class AtomGroup:
        def __init__(self, tag):
            self.tag = tag

    for cls, mod, name in ((Gibbs, gibbs_mod, "Gibbs"),
                           (AtomGroup, groups, "AtomGroup")):
        setattr(mod, name, cls)
        cls.__module__, cls.__qualname__ = mod.__name__, name
    mods = {"basicrta": types.ModuleType("basicrta"),
            "basicrta.gibbs": gibbs_mod,
            "MDAnalysis": types.ModuleType("MDAnalysis"),
            "MDAnalysis.core": types.ModuleType("MDAnalysis.core"),
            "MDAnalysis.core.groups": groups}
    sys.modules.update(mods)
    return mods, Gibbs, AtomGroup


def _drop_stand_ins(mods):
    for name in mods:
        sys.modules.pop(name, None)


def legacy_tree(tmp):
    """12a: a planted system's events on the card, written as the
    reference package's ``contacts_7.0.pkl``; ``gibbs`` on the pickle
    against ``gibbs`` on the ``.npz`` of the same events (samples bitwise
    equal, K2/K3 launched, plain versions never); the chains written as a
    reference results tree of ``gibbs_{niter}.pkl``; ``cluster`` over it
    (post-processing on the card) and ``kinetics`` from the pickles."""
    import pickle

    from basicrta_torch.contacts.records import ContactEvents
    from basicrta_torch.io.legacy import (load_reference_contacts,
                                          load_reference_gibbs)
    from basicrta_torch.sampler.gibbs import Gibbs
    from basicrta_torch.scripts import e2e_demo
    niter = 2000
    root = os.path.join(tmp, "legacy")
    os.makedirs(root)
    log = os.path.join(root, "cli.log")
    e2e_demo.make_system(root, 24, 12, 1500, 0.1,
                         np.random.default_rng(11))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _quiet_cli(["contacts", "--top", "top.gro", "--traj", "traj.xtc",
                    "--sel1", "protein", "--sel2", "resname CHOL",
                    "--cutoff", "7.0"], log)
        events = ContactEvents.load("contacts_7.0.npz")
        mods, RefGibbs, AtomGroup = _stand_in_modules()
        try:
            dtype = np.dtype(np.float64, metadata={
                "top": os.path.abspath("top.gro"),
                "traj": os.path.abspath("traj.xtc"),
                "ag1": AtomGroup("protein"), "ag2": AtomGroup("CHOL"),
                "ts": 0.1, "cutoff": 7.0})
            rows = np.stack([events.sel1_resids, events.sel2_resids,
                             events.start_times, events.durations], 1)
            with open("contacts_7.0.pkl", "wb") as f:
                pickle.dump(rows.astype(dtype), f, protocol=5)
        finally:
            _drop_stand_ins(mods)
        loaded = load_reference_contacts("contacts_7.0.pkl")
        for f in ("sel1_resids", "sel2_resids", "start_times", "durations"):
            require(np.array_equal(getattr(loaded, f), getattr(events, f)),
                    f"12a: the pickle's {f} differ from the .npz's")
        runs = {}
        for kind in ("pkl", "npz"):
            # each run from here (the topology names the labels), its
            # results tree moved aside after it
            _reset_sweep_launches()
            t0 = time.time()
            _quiet_cli(["gibbs", "--contacts", f"contacts_7.0.{kind}",
                        "--niter", str(niter)], log)
            runs[kind] = (time.time() - t0, _sweep_launches())
            os.makedirs(kind)
            os.rename("basicrta-7.0", os.path.join(kind, "basicrta-7.0"))
        # residues with results (too few events leave a sentinel only)
        labels, other = (sorted(lab for lab in os.listdir(
            f"{kind}/basicrta-7.0") if os.path.exists(
                f"{kind}/basicrta-7.0/{lab}/gibbs_{niter}.npz"))
            for kind in ("pkl", "npz"))
        require(labels and labels == other, "12a: residue sets differ")
        for lab in labels:
            a, b = (Gibbs.load(f"{kind}/basicrta-7.0/{lab}/"
                               f"gibbs_{niter}.npz") for kind in ("pkl",
                                                                  "npz"))
            require(np.array_equal(a.mcweights, b.mcweights)
                    and np.array_equal(a.mcrates, b.mcrates),
                    f"12a: {lab}'s samples from the .pkl differ from the "
                    ".npz run's")
        for kind, (sec, n) in runs.items():
            require(n["segment"] + n["segment_packed"] > 0 and
                    n["segment_torch"] + n["segment_packed_torch"] == 0,
                    f"12a: gibbs on the .{kind} launched {n}")
        # the chains as a reference results tree of gibbs_{niter}.pkl
        mods, RefGibbs, _ = _stand_in_modules()
        try:
            for lab in labels:
                g = Gibbs.load(f"pkl/basicrta-7.0/{lab}/gibbs_{niter}.npz")
                r = RefGibbs()
                r.times, r.residue, r.cutoff, r.ts = (g.times, lab, 7.0,
                                                      0.1)
                r.ncomp, r.niter, r.g, r.burnin = (g.cfg.ncomp, niter,
                                                   g.cfg.g, g.cfg.burnin)
                r.mcweights, r.mcrates = g.mcweights[0], g.mcrates[0]
                os.makedirs(f"ref/basicrta-7.0/{lab}")
                with open(f"ref/basicrta-7.0/{lab}/gibbs_{niter}.pkl",
                          "wb") as f:
                    pickle.dump(r, f, protocol=5)
        finally:
            _drop_stand_ins(mods)
        g0 = load_reference_gibbs(f"ref/basicrta-7.0/{labels[0]}/"
                                  f"gibbs_{niter}.pkl")
        require(g0.mcweights.shape[0] == 1 and g0.processed is None,
                "12a: a migrated residue has one chain, no processed state")
        os.chdir("ref")
        _reset_sweep_launches()
        t0 = time.time()
        _quiet_cli(["cluster", "--cutoff", "7.0", "--niter", str(niter)],
                   log)
        cluster_s = time.time() - t0
        taus = np.load("tausout.npy")
        # kinetics on the migrated residue with the most events
        top = max(labels, key=lambda lab: int(
            (events.sel1_resids == int(lab[1:])).sum()))
        t0 = time.time()
        _quiet_cli(["kinetics", "--gibbs",
                    f"basicrta-7.0/{top}/gibbs_{niter}.pkl", "--contacts",
                    "../contacts_7.0.pkl", "--wdensity"], log)
        kinetics_s = time.time() - t0
        dx = sorted(x for x in os.listdir(f"basicrta-7.0/{top}")
                    if x.endswith(".dx"))
    finally:
        os.chdir(cwd)
    require(len(taus) == len(labels) and np.all(np.isfinite(taus)),
            "12a: a migrated residue's tau is not finite")
    lo, hi = taus[:, 2], taus[:, 3]
    require(np.all((0 <= lo) & (lo <= hi)), "12a: CI not 0 <= lo <= hi")
    require(dx, "12a: kinetics from the pickles wrote no density")
    print(f"phase 12a legacy: {len(events)} events of {len(labels)} "
          f"residues as contacts_7.0.pkl; gibbs --contacts .pkl "
          f"{runs['pkl'][0]:.2f} s, .npz {runs['npz'][0]:.2f} s, samples "
          f"bitwise equal; launches {runs['pkl'][1]}; reference tree of "
          f"{len(labels)} gibbs_{niter}.pkl -> cluster {cluster_s:.2f} s "
          f"(tau finite, 0 <= lo <= hi; median tau "
          f"{float(np.median(taus[:, 1])):.3f} ns), kinetics of {top} from "
          f".pkl {kinetics_s:.2f} s ({len(dx)} .dx)",
          flush=True)


def _kernel_launch_gate(what, need_k2=True, need_k3=True):
    n = _sweep_launches()
    require((n["segment"] > 0 or not need_k2)
            and (n["segment_packed"] > 0 or not need_k3)
            and n["segment_torch"] + n["segment_packed_torch"] == 0,
            f"{what}: launches {n}")
    return n


def layout_tools(tmp):
    """12b: ``calibrate_layout`` on protein-300 (mixed, uniform, pow2; 2
    reps); 12c: ``layout_sweep``'s five variants at 10,000 sweeps, 2
    reps."""
    from basicrta_torch.scripts import calibrate_layout, layout_sweep
    from basicrta_torch.scripts.workload import bench_residues
    residues = bench_residues()
    _reset_sweep_launches()
    t0 = time.time()
    rows = calibrate_layout.measure(
        residues, ["mixed", "uniform", "pow2"], 2000, 8000, 2,
        __import__("torch").device("cuda"), log=io.StringIO())
    buf = io.StringIO()
    coef, r2 = calibrate_layout.report(rows, out=buf)
    n = _kernel_launch_gate("12b calibrate_layout")
    with open(os.path.join(tmp, "calibration.json"), "w") as f:
        json.dump(rows, f)
    print("phase 12b calibrate_layout (buckets in series; production "
          "runs them at once):" + buf.getvalue().replace(
              "\n", "\nphase 12b "), flush=True)
    print(f"phase 12b refit {json.dumps(dict(zip(calibrate_layout.COEF_NAMES, [float(c) for c in coef])))} "
          f"r2 {r2:.6g}, {len(rows)} buckets, launches {n}, "
          f"{time.time() - t0:.1f} s", flush=True)
    _reset_sweep_launches()
    t0 = time.time()
    res = layout_sweep.sweep(
        residues, list(layout_sweep.VARIANTS), 10_000, 2, "cuda",
        out=lambda line: print(f"phase 12c {line}", flush=True))
    n = _kernel_launch_gate("12c layout_sweep")
    ranking = sorted(((float(np.median(ts)), v) for v, (_, ts)
                      in res.items()))
    print("phase 12c ranking " + json.dumps(
        [{"variant": v, "lane_sweeps_per_s": len(residues) * 10_000 / m,
          "median_s": m, "model_us_per_sweep": res[v][0]}
         for m, v in ranking]) + f", launches {n}, "
          f"{time.time() - t0:.1f} s", flush=True)


def post_and_contacts_tools():
    """12d: ``postbench``'s stage split (outputs with ``timings`` bitwise
    those without); 12e: ``cbench``'s three variants, rows equal."""
    import torch

    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.scripts import cbench, postbench
    from basicrta_torch.scripts.workload import make_membrane_frames
    dev = torch.device("cuda")
    t0 = time.time()
    items, cfg = postbench.make_items(64, dev)
    pcfg = GibbsConfig(ncomp=15, niter=cfg.niter, g=100,
                       burnin=cfg.niter // 10)
    total, stages, same = postbench.bench(items, pcfg, 3, dev)
    require(same, "12d: the timings hook changed the outputs")
    print(f"phase 12d postbench: {len(items)} residues, warm total "
          f"{total:.4f} s ({total / len(items) * 1e3:.2f} ms/residue), "
          f"stages {json.dumps(stages)}, timings bitwise no-op, "
          f"{time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    batches, r1, r2, A1 = make_membrane_frames(n_frames=96)
    fps = cbench.bench(batches, r1, r2, A1, 5, dev,
                       out=lambda line: None)
    print("phase 12e cbench (96 membrane frames, rows of every variant "
          "equal the dense kernel's): median frames/s " + json.dumps(
              {k: float(np.median(v)) for k, v in fps.items()})
          + f", {time.time() - t0:.1f} s", flush=True)


def e2e_and_entry(tmp):
    """12f: ``e2e_demo`` at its defaults on the card; 12g: ``entry()`` and
    ``dryrun_multichip(2)``."""
    from basicrta_torch import entry
    from basicrta_torch.scripts import e2e_demo
    _reset_sweep_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        seconds, planted, median = e2e_demo.run(os.path.join(tmp, "e2e"))
    n = _kernel_launch_gate("12f e2e_demo", need_k2=False, need_k3=False)
    require(n["segment"] + n["segment_packed"] > 0,
            f"12f: no sweep kernel launched {n}")
    require(np.isfinite(median), "12f: no residue got a tau")
    print(f"phase 12f e2e_demo (120 residues, 60 lipids, 5,000 frames, "
          f"110,000 sweeps): stage seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}, "
          f"planted slowest tau {planted:.2f} ns, median tau "
          f"{median:.3f} ns, launches {n}", flush=True)
    t0 = time.time()
    fn, args = entry.entry()
    st, W, R = fn(*args)
    require(tuple(W.shape) == (8, 2, 15) and bool(W.isfinite().all()),
            "12g: entry's block")
    _reset_sweep_launches()
    legs = []
    entry.dryrun_multichip(2, out=legs.append)
    n = _kernel_launch_gate("12g dryrun_multichip")
    print(f"phase 12g entry OK, dryrun_multichip(2) {len(legs)} legs OK "
          f"({'; '.join(legs)}), launches {n}, {time.time() - t0:.1f} s",
          flush=True)


def tools_phase(tmp):
    """Phase 12: 12a-12g, each with its seconds."""
    marks = [time.time()]
    legacy_tree(tmp)
    marks.append(time.time())
    layout_tools(tmp)
    marks.append(time.time())
    post_and_contacts_tools()
    marks.append(time.time())
    e2e_and_entry(tmp)
    marks.append(time.time())
    steps = ("12a", "12b-c", "12d-e", "12f-g")
    print("phase 12 seconds: " + ", ".join(
        f"{k} {b - a:.1f}" for k, a, b in zip(steps, marks, marks[1:]))
        + f", total {marks[-1] - marks[0]:.1f}", flush=True)


# ------------------------------------------------------------- phase 13
FAMILY_FRAMES = 96             # phase 13a's membrane trajectory
PRMTOP_TEXT = (
    "%VERSION  VERSION_STAMP = V0001.000  DATE = 08/18/26\n"
    "%FLAG TITLE\n%FORMAT(20a4)\ntest\n"
    "%FLAG ATOM_NAME\n%FORMAT(20a4)\n"
    "N   CA  C   N   CA  C1  C2  C1  C2\n"
    "%FLAG RESIDUE_LABEL\n%FORMAT(20a4)\nTRP ALA CHOLCHOL\n"
    "%FLAG RESIDUE_POINTER\n%FORMAT(10I8)\n"
    "       1       4       6       8\n"
    "%FLAG AMBER_ATOM_TYPE\n%FORMAT(20a4)\n"
    "N   CX  C   N   CX  CT  CT  CT  CT\n")
PSF_TEXT = """PSF EXT CMAP

         1 !NTITLE
* SMOKE

         9 !NATOM
         1 PROA     10       TRP      N        NH1     -0.470000       14.00700           0
         2 PROA     10       TRP      CA       CT1      0.070000       12.01100           0
         3 PROA     10       TRP      C        C        0.510000       12.01100           0
         4 PROA     11       ALA      N        NH1     -0.470000       14.00700           0
         5 PROA     11       ALA      CA       CT1      0.070000       12.01100           0
         6 MEMB     100      CHOL     C1       CTL1     0.000000       12.01100           0
         7 MEMB     100      CHOL     C2       CTL2     0.000000       12.01100           0
         8 MEMB     101      CHOL     C1       CTL1     0.000000       12.01100           0
         9 MEMB     101      CHOL     C2       CTL2     0.000000       12.01100           0

         0 !NBOND: bonds
"""


def _tpr_dump(first_resid):
    """``gmx dump -s`` text of a small system: one protein chain of three
    residues (N, CA; author numbering from ``first_resid``) and three CHOL
    copies of four atoms, coordinates 0.2 nm apart, a 5 x 5 x 4 nm box."""
    def atoms(n, resind, names, mass):
        return ("         atom (%d):\n" % n + "".join(
            f"            atom[{i:6d}]={{type=  0, typeB=  0, "
            f"ptype=    Atom, m= {mass(i):.5e}, q= 0.00000e+00, "
            f"resind= {resind(i):4d}, atomnumber=  6}}\n" for i in range(n))
            + "         atom (%d):\n" % n + "".join(
                f'            atom[{i}]={{name="{names[i]}"}}\n'
                for i in range(n)))
    prot = atoms(6, lambda i: i // 2, ["N", "CA"] * 3,
                 lambda i: 14.007 if i % 2 == 0 else 12.011)
    chol = atoms(4, lambda i: 0, ["C1", "C2", "C3", "O1"],
                 lambda i: 15.999 if i == 3 else 12.011)
    res = "".join(f'            residue[{k}]={{name="{n}", '
                  f"nr={first_resid + k}, ic=' '}}\n"
                  for k, n in enumerate(("TRP", "LEU", "ALA")))
    return (
        "smoke.tpr:\ntopology:\n   name=\"smoke\"\n   #atoms = 18\n"
        "   #molblock = 2\n"
        "   molblock (0):\n"
        "      moltype              = 0 \"Protein_chain_A\"\n"
        "      #molecules           = 1\n"
        "   molblock (1):\n      moltype              = 1 \"CHOL\"\n"
        "      #molecules           = 3\n"
        "   moltype (0):\n      name=\"Protein_chain_A\"\n      atoms:\n"
        + prot + "         residue (3):\n" + res +
        "   moltype (1):\n      name=\"CHOL\"\n      atoms:\n" + chol
        + "         residue (1):\n"
        "            residue[0]={name=\"CHOL\", nr=1, ic=' '}\n"
        "box (3x3):\n"
        "   box[    0]={ 5.00000e+00,  0.00000e+00,  0.00000e+00}\n"
        "   box[    1]={ 0.00000e+00,  5.00000e+00,  0.00000e+00}\n"
        "   box[    2]={ 0.00000e+00,  0.00000e+00,  4.00000e+00}\n"
        "x (18x3):\n" + "".join(
            f"   x[{i:5d}]={{ {0.2 * i:.5e},  1.00000e+00,  1.00000e+00}}\n"
            for i in range(18)))


def _contacts_cli(work, top, traj, cpu=False):
    """``contacts`` through the CLI in ``work`` (its own directory), on
    the card unless ``cpu``: (records, events, seconds)."""
    from basicrta_torch.contacts.records import ContactEvents, ContactRecords
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.time()
        _quiet_cli(["contacts", "--top", top, "--traj", traj, "--sel1",
                    "protein", "--sel2", "resname CHOL", "--cutoff", "7.0",
                    *(["--device", "cpu"] if cpu else [])], "cli.log")
        secs = time.time() - t0
        return (ContactRecords.load("contacts.npz"),
                ContactEvents.load("contacts_7.0.npz"), secs)
    finally:
        os.chdir(cwd)


def _rows_agree(what, a, b):
    """Hold two scans' contact rows against each other on every frame:
    rows on one side only must lie within 1e-4 A of the map cutoff, and
    shared rows agree within 1e-4 A (``check_frame``'s gate, PERF.md §2).
    Returns (shared, lone)."""
    from basicrta_torch.scripts.contacts_reference import check_frame
    cutoff = a.meta.cutoff
    require(b.meta.cutoff == cutoff, f"13 {what}: map cutoffs differ")
    shared = lone = 0
    for f in np.union1d(a.frames, b.frames):
        rows = [(r.sel1_resids[r.frames == f], r.sel2_resids[r.frames == f],
                 r.min_dist[r.frames == f]) for r in (a, b)]
        try:
            s, n, _ = check_frame(rows[0], rows[1], cutoff)
        except AssertionError as e:
            raise RuntimeError(f"13 {what} frame {f}: {e}") from e
        shared, lone = shared + s, lone + n
    require(shared > 0, f"13 {what}: no contact rows")
    return shared, lone


def family_membrane(tmp):
    """13a: the membrane of phase 8a (96 frames) as ``.xtc``, ``.trr``,
    ``.dcd`` and ``.ncdf`` through the CLI on the card; the f32 formats
    each against a ``--device cpu`` run on the same file, and the ``.trr``
    rows against the ``.dcd`` rows."""
    from basicrta_torch.io.native import trajectory_writer
    from basicrta_torch.scripts.workload import (make_membrane_frames,
                                                 write_membrane_files)
    base = os.path.join(tmp, "families")
    os.makedirs(base)
    batches, r1, r2, _ = make_membrane_frames(n_frames=FAMILY_FRAMES,
                                              batch=32)
    gro, xtc = write_membrane_files(base, batches, r1, r2)
    trajs = {"xtc": xtc}
    for ext in ("trr", "dcd", "ncdf"):
        trajs[ext] = os.path.join(base, f"membrane.{ext}")
        with trajectory_writer(trajs[ext], dt_ns=0.1) as w:
            for b in batches:
                w.write(b.positions, b.times, b.box,
                        steps=np.asarray(b.frame_ids, np.int32))
    del batches
    card = {}
    for ext, traj in trajs.items():
        rec, ev, secs = _contacts_cli(os.path.join(base, ext), gro, traj)
        require(len(ev) > 0, f"13a {ext}: no events")
        require(abs(rec.meta.ts - 0.1) < 1e-6, f"13a {ext}: ts {rec.meta.ts}")
        card[ext] = rec
        line = (f"phase 13a {ext}: {FAMILY_FRAMES} frames x "
                f"{len(r1) + len(r2)} atoms, card {secs:.3f} s = "
                f"{FAMILY_FRAMES / secs:.1f} frames/s end to end, "
                f"{len(rec)} rows, {len(ev)} events")
        if ext != "xtc":      # the f32 formats: the CPU reads the same rows
            crec, _, csecs = _contacts_cli(os.path.join(base, ext + "_cpu"),
                                           gro, traj, cpu=True)
            shared, lone = _rows_agree(f"13a {ext} card/CPU", rec, crec)
            line += (f"; --device cpu {csecs:.3f} s, {shared} rows equal, "
                     f"{lone} within 1e-4 A of the cutoff on one side only")
        print(line, flush=True)
    # TRR keeps nm, DCD Angstrom: the same frames to f32 rounding
    shared, lone = _rows_agree("13a trr/dcd", card["trr"], card["dcd"])
    print(f"phase 13a trr against dcd on the card: {shared} rows equal, "
          f"{lone} within 1e-4 A of the cutoff on one side only",
          flush=True)


def family_tpr(tmp):
    """13b: a raw ``.tpr`` on the card through a stub ``gmx`` on
    ``BASICRTA_GMX``, then rewritten with the same size and mtime: the
    content-keyed cache must render it again and give the new rows."""
    from basicrta_torch.io.native import XTCWriter
    work = os.path.join(tmp, "tpr")
    os.makedirs(work)
    payload, calls = os.path.join(work, "payload.dump"), \
        os.path.join(work, "gmx_calls")
    gmx = os.path.join(work, "gmx")
    with open(gmx, "w") as f:
        f.write(f"#!/bin/sh\necho x >> {calls}\n"
                f"[ \"$1\" = dump ] && [ \"$2\" = -s ] || exit 2\n"
                f"exec cat {payload}\n")
    os.chmod(gmx, 0o755)
    tpr = os.path.join(work, "x.tpr")
    # CHOL copy 1 within 7 A of the first N in frames 1-3, far otherwise
    first = np.tile(np.arange(18, dtype=np.float32)[:, None] * 2.0, (1, 3))
    frames = np.repeat(first[None], 6, axis=0)
    for k in range(6):
        frames[k, 6:10] = first[0] + (2.0 if 1 <= k <= 3 else 20.0)
    traj = os.path.join(work, "t.xtc")
    XTCWriter(traj).write(frames, np.arange(6) * 0.1,
                          np.tile([50.0, 50.0, 40.0], (6, 1)))
    old_env = os.environ.get("BASICRTA_GMX")
    os.environ["BASICRTA_GMX"] = gmx
    try:
        pairs = []
        for k, (resid0, blob) in enumerate(((313, b"\x00\x01tpr-v1"),
                                            (413, b"\x00\x01tpr-v2"))):
            with open(payload, "w") as f:
                f.write(_tpr_dump(resid0))
            with open(tpr, "wb") as f:
                f.write(blob)                        # the same size
            if k:                                    # and the cache's mtime
                stamp = os.stat(tpr + ".dump").st_mtime_ns
                os.utime(tpr, ns=(stamp, stamp))
            _, ev, _ = _contacts_cli(os.path.join(work, f"run{k}"), tpr,
                                     traj)
            pairs.append(sorted(set(zip(ev.sel1_resids.tolist(),
                                        ev.sel2_resids.tolist()))))
        with open(calls) as f:
            n_calls = f.read().count("x")
    finally:
        if old_env is None:
            os.environ.pop("BASICRTA_GMX", None)
        else:
            os.environ["BASICRTA_GMX"] = old_env
    require(n_calls == 2, f"13b: gmx ran {n_calls} times, not 2")
    require((313, 316) in pairs[0] and (413, 416) in pairs[1]
            and all(r1 >= 413 for r1, _ in pairs[1]),
            f"13b: the rewritten .tpr's rows {pairs}")
    print(f"phase 13b raw .tpr: gmx ran {n_calls} times (rewrite of the "
          f"same size and mtime rendered again); event pairs {pairs[0]} "
          f"then {pairs[1]}", flush=True)


def family_fixtures(tmp):
    """13c: ``prmtop`` + NetCDF and PSF + TRR fixtures through the CLI on
    the card, rows against the CPU's, and the planted event."""
    from basicrta_torch.io.native import TRRWriter, trajectory_writer
    pos = np.zeros((8, 9, 3), np.float32)
    pos[:, 0:3], pos[:, 3:5] = 10.0, 40.0
    pos[:, 5:7], pos[:, 7:9] = 70.0, 80.0
    pos[2:5, 5:7] = [12.0, 10.0, 10.0]         # CHOL 1 visits the protein
    work = os.path.join(tmp, "amber_charmm")
    os.makedirs(work)
    cases = []
    for name, text, ext, want in (("prmtop", PRMTOP_TEXT, "ncdf", (1, 3)),
                                  ("psf", PSF_TEXT, "trr", (10, 100))):
        top = os.path.join(work, f"t.{name}")
        with open(top, "w") as f:
            f.write(text)
        traj = os.path.join(work, f"t.{ext}")
        writer = trajectory_writer(traj) if ext == "ncdf" else \
            TRRWriter(traj)
        with writer as w:
            w.write(pos, np.arange(8) * 0.1, np.tile([90.0] * 3, (8, 1)))
        rec, ev, _ = _contacts_cli(os.path.join(work, name), top, traj)
        crec, _, _ = _contacts_cli(os.path.join(work, name + "_cpu"), top,
                                   traj, cpu=True)
        shared, lone = _rows_agree(f"13c {name}", rec, crec)
        got = {(int(x), int(y)): (s, d) for x, y, s, d in zip(
            ev.sel1_resids, ev.sel2_resids, ev.start_times, ev.durations)}
        require(want in got and abs(got[want][0] - 0.2) < 1e-6
                and abs(got[want][1] - 0.3) < 1e-6,
                f"13c {name}: events {got}")
        cases.append(f"{name} + {ext}: {shared} rows equal the CPU's, "
                     f"{lone} on one side only, event {want} at "
                     f"{got[want][0]:.1f} ns for {got[want][1]:.1f} ns")
    print("phase 13c " + "; ".join(cases), flush=True)


def file_families(tmp):
    """Phase 13: ``contacts`` through the CLI on the card from each file
    family (13a-13c), with each step's seconds."""
    marks = [time.time()]
    for step in (family_membrane, family_tpr, family_fixtures):
        step(tmp)
        marks.append(time.time())
    print("phase 13 seconds: " + ", ".join(
        f"{k} {b - a:.2f}" for k, a, b in zip(("13a", "13b", "13c"), marks,
                                               marks[1:]))
        + f", total {marks[-1] - marks[0]:.1f}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from basicrta_torch.io import native
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.scripts.workload import make_workload

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} ({smi}), "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.time()
    sources = ("sweep.cu", "prng.cu", "ceiling.cu")
    with ThreadPoolExecutor(len(sources) + 2) as pool:
        builds = [pool.submit(cs.build_library, True, src)
                  for src in sources]
        # K5's counter build (phase 5)
        builds.append(pool.submit(cs.build_library, True, "prng.cu",
                                  ("BASICRTA_PRNG_STATS",)))
        builds.append(pool.submit(native.build_library))
        for b in builds:
            b.result()
    print(f"phase 1 build: {time.time() - t0:.2f} s", flush=True)

    if len(sys.argv) > 1:
        # python3 chip_smoke.py --only 5,8,9,10: the phases that stand
        # alone, while iterating on them; prints no result line
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
        require(only <= {"5", "8", "9", "10", "11", "12", "13"},
                "--only takes 5, 8, 9, 10, 11, 12 and/or 13")
        if "5" in only:
            prng_checks()
        with tempfile.TemporaryDirectory() as tmp:
            if only & {"8", "9"}:
                work, label = contacts_file_to_tau(tmp)
            if "8" in only:
                contacts_bilayer(tmp)
            if only & {"9", "10", "11"}:
                workload = make_workload()
            if only & {"9", "10"}:
                from basicrta_torch.sampler.gibbs import Gibbs
                g = Gibbs(workload[0], residue="R0", cutoff=7.0,
                          root=tmp).run()
                g.process_gibbs()
                g.estimate_tau()
            if "9" in only:
                kinetics_file(work, label)
                densities_full_size(g, work, label, tmp)
            if "10" in only:
                reference_phase(workload, g, tmp)
            if "11" in only:
                sharded_phase(workload, tmp)
            if "12" in only:
                tools_phase(tmp)
            if "13" in only:
                file_families(tmp)
        print(f"partial run (phases 1, {sorted(only)}): no result")
        return 0
    workload = make_workload()
    report = kernel_checks(workload)
    k3 = packed_checks(workload)
    with tempfile.TemporaryDirectory() as tmp:
        launches, pow2_launches, layouts = protein_run(workload, tmp)
        flagship = full_runs(workload, tmp)
    k5 = prng_checks()
    k4 = tree_checks(workload, layouts["production"][0])
    k6 = roofline_checks(layouts, report, k3, k5)
    with tempfile.TemporaryDirectory() as tmp:
        work, label = contacts_file_to_tau(tmp)
        contacts_bilayer(tmp)
        kinetics_file(work, label)
        densities_full_size(flagship, work, label, tmp)
        reference_phase(workload, flagship, tmp)
        sharded_phase(workload, tmp)
        tools_phase(tmp)
        file_families(tmp)
    require("jax" not in sys.modules, "jax was imported")
    require("basicrta_tpu" not in sys.modules, "basicrta_tpu was imported")

    f, t = report["flagship"], k4["report"]["mixed"]
    none = ("none: no single PyTorch call draws a multinomial per element "
            "with a per-element count")
    sweep = "basicrta_torch/csrc/sweep.cu"
    rows = [
        ("segment", sweep, "basicrta_tpu/sampler/pallas_sweep.py:1117",
         pow2_launches["segment"], max(r["k2_err"] for r in report.values()),
         f["k2_ms_10sweeps"], f["k2_plain_ms_10sweeps"], None),
        ("segment_packed", sweep, "basicrta_tpu/sampler/pallas_sweep.py:1238",
         launches["segment_packed"], max(r["k3_err"] for r in k3.values()),
         k3["mixed"]["k3_ms_10sweeps"], k3["mixed"]["k3_plain_ms_10sweeps"],
         None),
        ("sweep_stats", sweep, "basicrta_tpu/sampler/pallas_sweep.py:930",
         sum(r["k1_launches"] for r in report.values()),
         max(r["k1_err"] for r in report.values()), f["k1_ms"],
         f["k1_plain_ms"], None),
        ("suff_stats_tree", sweep, "basicrta_tpu/sampler/pallas_sweep.py:733",
         k4["launches"], k4["err"], t["k3_ms_10sweeps"],
         t["k3_plain_ms_10sweeps"], None),
        ("prng_draws", "basicrta_torch/csrc/prng.cu",
         "scripts/device_prng.py:40", k5["launches"], k5["err"], k5["ms"],
         k5["plain_ms"], k5["library_ms"]),
        ("transcendental_ceiling", "basicrta_torch/csrc/ceiling.cu",
         "bench.py:388", k6["launches"], k6["err"], k6["ms"],
         k6["plain_ms"], k6["library_ms"]),
    ]
    kernels = {"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep, launches=n,
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=k6["bounds"][name][0], bound_by=k6["bounds"][name][1],
        library_ms=lib, **({} if lib is not None else {"library": none}))
        for name, src, rep, n, err, ms, plain_ms, lib in rows]}
    for row in kernels["kernels"]:
        print(f"phase 7 share {row['name']}: {row['ms']:.6g} ms is "
              f"{100 * row['bound_ms'] / row['ms']:.4g}% of its bound's "
              f"rate", flush=True)
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
