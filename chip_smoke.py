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
   multi-row bucket, each with a bitwise resume check.
3. the protein: 300 residues (bench.py's make_workload recipe) x 2 chains
   through the CLI ``gibbs`` (10,000 sweeps, one production segment) and
   ``cluster`` commands, on the production layout (K3 for the packed
   buckets, K2 for any unpacked one) with bucketed post-processing; every
   residue must get a finite tau and a CI with 0 <= lo <= hi (a tau outside
   its own CI is reported, not failed: the estimator's histogram mode can
   leave the percentile CI), and the run must have launched the fused
   kernels, never a plain version. A profiled re-run of the
   post-processing counts its device activities per residue. Then the
   same 300 x 2 lanes run the same sweeps on the pow2 ladder (K2 only),
   sampling only, so both layouts' lane-sweeps/s stand side by side.
4. full-length runs through ``Gibbs``: the verify recipe (5e4 events,
   niter 11,000, its 95% CI must cover the slowest truth tau = 50) and the
   flagship residue at the default GibbsConfig (110,000 sweeps).
5. the device-PRNG probe (K5) against its plain version (uniform bits
   identical), then the goodness-of-fit battery on the kernel's draws.

Output: one JSON line of per-kernel results, the card's ``nvidia-smi``
name/power line, and last ``{"ok": true, "device": {...}}``. Without a
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

W313_EVENTS = 446_605
N_RESIDUES = 300
PROTEIN_SWEEPS = 10_000   # one production segment (bench.py TIMED_SWEEPS)


def simulate_hyperexp(n, weights, rates, rng):
    """Sorted hyperexponential draws (basicrta_tpu.ops.surv recipe)."""
    weights = np.asarray(weights, np.float64)
    rates = np.asarray(rates, np.float64)
    comp = rng.choice(len(weights), size=int(n), p=weights / weights.sum())
    x = -np.log(rng.random(int(n))) / rates[comp]
    x.sort()
    return x


def discretize(times, ts=0.1):
    return np.maximum(np.round(np.asarray(times) / ts), 1.0) * ts


def make_workload(n_residues=N_RESIDUES, seed=0):
    """bench.py's synthetic all-residue workload: one W313-scale flagship
    and log-uniform 10^2..10^5.3-event residues."""
    rng = np.random.default_rng(seed)
    w = np.array([0.87, 0.09, 0.03, 0.009, 0.001])
    r = np.array([4.7, 1.3, 0.33, 0.06, 0.009])
    sizes = np.concatenate([
        [W313_EVENTS],
        (10 ** rng.uniform(2.0, 5.3, n_residues - 1)).astype(int)])
    residues = {}
    for i, n in enumerate(sizes):
        scale = rng.uniform(0.7, 1.5)
        residues[i] = discretize(simulate_hyperexp(int(n), w, r * scale,
                                                   rng))
    return residues


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


def kernel_checks(workload):
    """Phase 2: K1 and K2 against their plain versions on the card."""
    import torch
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler import cuda_sweep as cs
    from basicrta_torch.sampler.batch import bucket_residues
    from basicrta_torch.sampler.kernels import MixtureState, \
        init_mixture_params

    dev = torch.device("cuda")
    K = 15
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
    report = {}
    for label, batch in (("flagship", flag[0]), ("b128", b128[0])):
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
        lane_ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
                   & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))
        agree = lane_ok.float().mean().item()
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
        report[label] = dict(B=B, V=V, tiers=tiers, k1_same=same,
                             k1_launches=k1_launches,
                             k1_err=k1_err, k2_agree=agree, k2_err=k2_err,
                             k1_ms=k1_ms, k1_plain_ms=k1_plain,
                             k2_ms_10sweeps=k2_ms,
                             k2_plain_ms_10sweeps=k2_plain)
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

    dev = torch.device("cuda")
    K = 15
    lanes = {f"R{i}#{c}": t for i, t in workload.items() for c in range(2)}
    mixed = max((b for b in batch.bucket_residues(lanes)
                 if b.bounds is not None), key=lambda b: len(b.bounds))
    require(mixed.pack >= 4, f"largest production bucket packs "
            f"{mixed.pack}-way")
    uniform = max((b for b in batch.bucket_residues(lanes, consolidate=False)
                   if b.pack == 2), key=lambda b: b.values.shape[1])
    require(uniform.values.shape[1] > 64, "uniform pack-2 bucket is one row")
    report = {}
    for label, bk in (("mixed", mixed), ("uniform_p2", uniform)):
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
        lane_ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
                   & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))[rows]
        agree = lane_ok.float().mean().item()
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
        report[label] = dict(pack=bk.pack, Bph=v.shape[0],
                             SL=v.shape[1] // 128, lanes=bk.size,
                             tiers=tiers, k3_agree=agree, k3_err=err,
                             resume_bitwise=resume, k3_ms_10sweeps=ms,
                             k3_plain_ms_10sweeps=plain)
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
    for name, layout_ in (("production", seen["layout"]), ("pow2", pow2)):
        secs = []
        for b in layout_:
            t0 = time.time()
            batch.run_batch(b, cfg, engine="cuda")
            torch.cuda.synchronize()
            secs.append(round(time.time() - t0, 3))
        print(f"phase 3 {name} per bucket (s): {secs}; total "
              f"{sum(secs):.3f} s -> {lane_sweeps / sum(secs):,.0f} "
              f"lane-sweeps/s", flush=True)
    return launches, pow2_launches


def full_runs(workload, tmp):
    """Phase 4: the verify recipe and the flagship at default settings."""
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler.gibbs import Gibbs

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
    print(f"phase 4 flagship default cfg: 110,000 sweeps in {run_s:.2f} s "
          f"({110_000 / run_s:,.0f} sweeps/s), total with post-processing "
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
    dp.draw_kernel.launches = dp.draw_plain.calls = 0
    failures, not_run = dp.run_battery(
        dev, out=lambda line: print(f"phase 5 {line}", flush=True))
    launches = dp.draw_kernel.launches
    require(dp.draw_plain.calls == 0, "the battery drew plain versions")
    require(not failures, f"GOF battery failed: {failures}")
    print(f"phase 5 K5: uniform bits identical; max_abs_err {err}; binom "
          f"(5000, 0.47) tile {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"battery passed on {launches} kernel launches", flush=True)
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from basicrta_torch.sampler import cuda_sweep as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} ({smi}), "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(cs.build_library, True, src)
                  for src in ("sweep.cu", "prng.cu")]
        for b in builds:
            b.result()
    print(f"phase 1 build: {time.time() - t0:.2f} s", flush=True)

    workload = make_workload()
    report = kernel_checks(workload)
    k3 = packed_checks(workload)
    with tempfile.TemporaryDirectory() as tmp:
        launches, pow2_launches = protein_run(workload, tmp)
        full_runs(workload, tmp)
    k5 = prng_checks()
    require("jax" not in sys.modules, "jax was imported")

    f = report["flagship"]
    kernels = {"kernels": [{
        "name": "segment",
        "route": "cuda",
        "source": "basicrta_torch/csrc/sweep.cu",
        "replaces": "basicrta_tpu/sampler/pallas_sweep.py:1117",
        "launches": pow2_launches["segment"],
        "max_abs_err": max(r["k2_err"] for r in report.values()),
        "ms": f["k2_ms_10sweeps"],
        "plain_ms": f["k2_plain_ms_10sweeps"],
    }, {
        "name": "segment_packed",
        "route": "cuda",
        "source": "basicrta_torch/csrc/sweep.cu",
        "replaces": "basicrta_tpu/sampler/pallas_sweep.py:1238",
        "launches": launches["segment_packed"],
        "max_abs_err": max(r["k3_err"] for r in k3.values()),
        "ms": k3["mixed"]["k3_ms_10sweeps"],
        "plain_ms": k3["mixed"]["k3_plain_ms_10sweeps"],
    }, {
        "name": "sweep_stats",
        "route": "cuda",
        "source": "basicrta_torch/csrc/sweep.cu",
        "replaces": "basicrta_tpu/sampler/pallas_sweep.py:930",
        "launches": sum(r["k1_launches"] for r in report.values()),
        "max_abs_err": max(r["k1_err"] for r in report.values()),
        "ms": f["k1_ms"],
        "plain_ms": f["k1_plain_ms"],
    }, {
        "name": "prng_draws",
        "route": "cuda",
        "source": "basicrta_torch/csrc/prng.cu",
        "replaces": "scripts/device_prng.py:40",
        "launches": k5["launches"],
        "max_abs_err": k5["err"],
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
