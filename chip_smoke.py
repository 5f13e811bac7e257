#!/usr/bin/env python3
"""Smoke run of basicrta_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. the card's name and power limit; build the CUDA kernels from
   ``basicrta_torch/csrc`` (one nvcc per source, all started together).
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
   identical), then the goodness-of-fit battery on the kernel's draws.
6. the tree multinomial (K4) in its three kernel forms against the plain
   tree: K1's and K2's on phase 2's pow2 buckets, K3's on its packed
   buckets, with K1-K3's pass rules and bitwise resume; exact totals and
   the moment check over 8 seeds; then the kernel A/B
   (``basicrta_torch.scripts.abench``) of ``full`` against ``tree_nat`` on
   protein-300's production layout, 2,000 sweeps, 3 reps.
7. the transcendental ceiling (K6) against its plain version (rtol 1e-6),
   the ceiling in exp/s beside the SFU peak, ``vpu_transcendental_util``
   of phase 3's production and pow2 layouts, and each kernel's bound.

Output: one JSON line of per-kernel results (each with its bound, and the
time of one PyTorch call that computes the same function where there is
one), the card's ``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

import contextlib
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate


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
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.finish_batch(loaded, save=False)
        torch.cuda.synchronize()
    prof_s = time.time() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"phase 3 post-processing profiled: {len(loaded)} residues in "
          f"{prof_s:.2f} s (profiler on), "
          f"{len(dev_events) / len(loaded):,.0f} device activities per "
          f"residue, device busy {busy / 1e6:.3f} s "
          f"({100 * busy / 1e6 / prof_s:.1f}%)", flush=True)

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


def prng_checks():
    """Phase 5: K5 against its plain version, then the GOF battery on the
    kernel's draws."""
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
        x = dp.draw_kernel(kind, 97, n, p, a, device=dev)
        y = dp.draw_plain(kind, 97, n, p, a, device=dev)
        same = torch.isclose(x, y, rtol=1e-4, atol=0).float().mean().item()
        require(same >= 0.999, f"K5 {kind} agrees in {same:.4f}")
        err = max(err, (x - y).abs().max().item())
    ms = cuda_ms(lambda: dp.draw_kernel("binom_h4", 97, 5000, 0.47,
                                        device=dev), 20)
    plain_ms = cuda_ms(lambda: dp.draw_plain("binom_h4", 97, 5000, 0.47,
                                             device=dev), 2)
    n = torch.full((256, 128), 5000.0, device=dev)
    p = torch.full((256, 128), 0.47, device=dev)
    library_ms = cuda_ms(lambda: torch.binomial(n, p), 20)
    dp.draw_kernel.launches = dp.draw_plain.calls = 0
    failures, not_run = dp.run_battery(
        dev, out=lambda line: print(f"phase 5 {line}", flush=True))
    launches = dp.draw_kernel.launches
    require(dp.draw_plain.calls == 0, "the battery drew plain versions")
    require(not failures, f"GOF battery failed: {failures}")
    print(f"phase 5 K5: uniform bits identical; max_abs_err {err}; binom "
          f"(5000, 0.47) tile {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"battery passed on {launches} kernel launches", flush=True)
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms)


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


def roofline_checks(layouts, k1k2, k3):
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
        "prng_draws": (rf.ROWS * rf.COLS, 4 * rf.ROWS * rf.COLS,
                       rf.ROWS * rf.COLS),
        "transcendental_ceiling": (rf.ceiling_ops(), 4 * rf.ROWS * rf.COLS,
                                   rf.ceiling_ops()),
    }
    bounds = {}
    for name, (trans, nbytes, static) in work.items():
        t_ops, t_bytes = trans / peak, nbytes / HBM_BYTES_PER_S
        bounds[name] = (1e3 * max(t_ops, t_bytes),
                        "operations" if t_ops >= t_bytes else "bytes")
        print(f"phase 7 bound {name}: {bounds[name][0]:.6g} ms "
              f"({bounds[name][1]}; {trans:,} transcendentals, {nbytes:,} "
              f"bytes; {1e3 * trans / ceiling:.6g} ms at the measured "
              f"ceiling; the reference layout's static count {static:,} "
              f"takes {1e3 * static / ceiling:.6g} ms there)", flush=True)
    return dict(ceiling=ceiling, peak=peak, launches=launches, err=err,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bounds=bounds)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.scripts.workload import make_workload

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} ({smi}), "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.time()
    sources = ("sweep.cu", "prng.cu", "ceiling.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = [pool.submit(cs.build_library, True, src)
                  for src in sources]
        for b in builds:
            b.result()
    print(f"phase 1 build: {time.time() - t0:.2f} s", flush=True)

    workload = make_workload()
    report = kernel_checks(workload)
    k3 = packed_checks(workload)
    with tempfile.TemporaryDirectory() as tmp:
        launches, pow2_launches, layouts = protein_run(workload, tmp)
        full_runs(workload, tmp)
    k5 = prng_checks()
    k4 = tree_checks(workload, layouts["production"][0])
    k6 = roofline_checks(layouts, report, k3)
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
