"""The tau job: ``gibbs`` then ``cluster``, from event table to tau table.

Set-up makes the event table of the configuration's dataset
(:func:`~rtabench.frozen.workload.synthetic_times`, the same times for
every seed), its rows in an order drawn from the seed, as a contact scan
leaves them, and warms up on it with a short job. A job is what the two
commands do in process: ``ParallelGibbs(events, cfg, root).run()`` on the card's kernels,
with its checkpoints, then ``ProcessProtein`` ``get_taus`` and
``write_data``. Every job writes into a fresh directory and samples from
the run seed plus its index, so no job resumes another's checkpoints.

The traced run wraps, from outside, ``bucket_residues`` (span ``layout``),
``run_residues`` (``run_residues``: layout, sampling and checkpoints) and
``finish_batch`` (``post``); the sampling is the second less the first.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

from rtabench.frozen import work
from rtabench.frozen import workload as wl
from rtabench.reference import tau as ref


def _gibbs_cfg(run, niter=None, seed_offset=0):
    from basicrta_torch.config import GibbsConfig
    g = run.config["gibbs"]
    niter = niter or g["niter"]
    burnin = g["burnin"] if niter == g["niter"] else niter // 2
    return GibbsConfig(ncomp=g["ncomp"], niter=niter, g=g["g"],
                       burnin=burnin, n_chains=g["n_chains"],
                       gamma_shape=g["gamma_shape"],
                       gamma_rate=g["gamma_rate"],
                       noise_cutoff=g["noise_cutoff"],
                       gmm_n_init=g["gmm_n_init"],
                       gmm_max_iter=g["gmm_max_iter"], gmm_tol=g["gmm_tol"],
                       weight_cut_events=g["weight_cut_events"],
                       seed=(run.seed + seed_offset) % (2 ** 31 - 1))


def setup(run):
    from basicrta_torch.contacts.records import ContactEvents, ContactMeta
    c = run.config
    durations = wl.synthetic_times(c["dataset"])
    order = np.random.default_rng([run.seed, 1]).permutation(len(durations))
    durations = durations[order]
    resids = np.full(len(durations), c["resid"], np.int32)
    events = ContactEvents(resids, np.zeros_like(resids),
                           np.zeros(len(resids)), durations,
                           ContactMeta(cutoff=c["cutoff"]))
    engine = "cuda" if run.on_card else "torch"
    return {"program": events, "resids": resids, "durations": durations,
            "engine": engine}


def _job(run, state, root, cfg):
    from basicrta_torch.protein.driver import ParallelGibbs, ProcessProtein
    dev = None if run.on_card else "cpu"
    ParallelGibbs(state["program"], cfg, root).run(engine=state["engine"],
                                                  device=dev)
    with run.spans.span("cluster"):
        pp = ProcessProtein(cfg=cfg, cutoff=run.config["cutoff"], root=root,
                            device=dev)
        pp.get_taus()
        return pp.write_data()


def warm(run, state):
    """A whole job at ``warm_niter`` sweeps: the same buckets, kernels
    and post-processing, on the same residues."""
    root = os.path.join(run.workdir, "warm")
    _job(run, state, root, _gibbs_cfg(run, niter=run.traffic["warm_niter"]))
    _sync(run)
    shutil.rmtree(root, ignore_errors=True)


def _sync(run):
    if run.on_card:
        import torch
        torch.cuda.synchronize()


def run_job(run, state, index):
    root = os.path.join(run.workdir, f"job{index}")
    cfg = _gibbs_cfg(run, seed_offset=index)
    try:
        table = _job(run, state, root, cfg)
        _sync(run)
        return {"root": root, "table": table, "error": None}
    except Exception as e:  # noqa: BLE001 - a failed job is counted
        return {"root": root, "table": None,
                "error": f"{type(e).__name__}: {e}"}


def instrument(run, state):
    from basicrta_torch.protein import driver
    from basicrta_torch.sampler import batch
    run.spans.wrap(batch, "bucket_residues", "layout",
                   payload=lambda bs: [(list(b.names), int(b.pack))
                                       for b in bs])
    run.spans.wrap(driver, "run_residues", "run_residues")
    run.spans.wrap(driver, "finish_batch", "post")


def account(run, state):
    """Work of the sweep kernels in the window: each lane's own
    transcendentals a sweep times the sweeps, by the kernel its bucket
    ran (K3 ``segment_packed`` where the bucket is packed, else K2
    ``segment``)."""
    split = ref.split_events(state["resids"], state["durations"])
    K, niter = run.config["gibbs"]["ncomp"], run.config["gibbs"]["niter"]
    per_res = {}
    for name, j, _, _, layout in run.spans.items:
        if name != "layout" or j < 0:
            continue
        for names, pack in layout:
            kern = "segment_packed" if pack > 1 else "segment"
            for lane in names:
                resid = int(lane.split("#")[0][1:])
                if resid not in per_res:
                    _, counts = np.unique(split[resid], return_counts=True)
                    per_res[resid] = work.lane_transcendentals(counts, K)
                run.work[kern] = run.work.get(kern, 0) + per_res[resid] * niter
    run.peak = work.sfu_peak(_max_sm_clock()) if run.on_card else None


def _max_sm_clock():
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    return float(out.stdout.split()[0])


def load_result(path):
    """The arrays of a residue's ``gibbs_{niter}.npz`` the check reads."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in ("times", "mcweights", "mcrates",
                                  "proc_labels") if k in z.files}


def judge_cluster(z, times, run, seed, dev):
    """(gmm_gap, tau_gap) of one residue's result ``z`` against the
    reference's ``cluster`` of the same chain."""
    g, chk = run.config["gibbs"], run.traffic["check"]
    b = g["burnin"] // g["g"]
    W = z["mcweights"][0, b:].astype(np.float64)
    R = z["mcrates"][0, b:].astype(np.float64)
    above, C, data, train = ref.cluster_inputs(W, R, len(times), g)
    labels = np.asarray(z.get("proc_labels", []), np.int64)
    if len(labels) != len(data) or not ((labels >= 0) & (labels < C)).all():
        return float("inf"), float("inf")
    X = np.log(data)
    mine = ref.gmm_labels(X[train], X, C, g["gmm_n_init"],
                          g["gmm_max_iter"], g["gmm_tol"], seed, dev)
    gmm_gap = (ref.fit_quality(X[train], mine[train], C, dev)
               - ref.fit_quality(X[train], labels[train], C, dev))
    got = z["row"]
    tau_gap = min(ref.rel_gap(got, want) for want in ref.taus(
        W, R, times, above, labels, C, g, dev, doubt=chk["noise_doubt"]))
    return max(gmm_gap, 0.0), tau_gap


def check(run, state):
    """{number: (value, limit)} and the failed jobs. ``split_off``:
    residues whose times differ from the reference's split of the table
    (or that have no result); ``loglik_gap``: the gap of the program's
    log-likelihood posterior from the reference sampler's;
    ``gmm_gap``: how much better a fit, in mean log-likelihood a point,
    the reference's own Gaussian mixture is than the program's labelling;
    ``tau_gap``: largest relative gap of a tau or CI bound from the
    reference's, worked out from that labelling."""
    import torch

    c, chk = run.config, run.traffic["check"]
    g = c["gibbs"]
    limits = c["limits"]["tau"]
    split = ref.split_events(state["resids"], state["durations"])
    b = g["burnin"] // g["g"]
    dev = "cuda" if run.on_card else "cpu"
    resids = sorted(split)
    RW, RR = ref.sample([split[r] for r in resids], g["ncomp"],
                        1.0 / g["ncomp"], g["gamma_shape"], g["gamma_rate"],
                        chk["ref_sweeps"], chk["ref_burnin"], chk["ref_thin"],
                        run.seed, dev, torch.float32)
    ll_ref = {r: ref.loglik(split[r], RW[i], RR[i], dev)
              for i, r in enumerate(resids)}
    failed, split_off = 0, 0
    gmm_gap, tau_gap, ll_gap = 0.0, 0.0, 0.0
    for j, rec in enumerate(run.records):
        if rec["error"] is not None:
            print(f"job {rec['root']} failed: {rec['error']}",
                  file=sys.stderr)
            failed += 1
            continue
        table = np.load(rec["table"])
        if (not np.isfinite(table).all()
                or np.any(table[:, 2] > table[:, 3])):
            failed += 1
        rows = {int(r[0]): r for r in table}
        base = os.path.join(rec["root"], f"basicrta-{c['cutoff']}")
        for resid, times in split.items():
            path = os.path.join(base, f"X{resid}", f"gibbs_{g['niter']}.npz")
            if not os.path.exists(path) or resid not in rows:
                split_off += 1
                continue
            z = load_result(path)
            if not np.array_equal(np.sort(z["times"]), times):
                split_off += 1
                continue
            z["row"] = (rows[resid][2], rows[resid][1], rows[resid][3])
            gg, tg = judge_cluster(z, times, run, run.seed * 1009 + j, dev)
            gmm_gap, tau_gap = max(gmm_gap, gg), max(tau_gap, tg)
            W = z["mcweights"][:, b:].reshape(-1, g["ncomp"])
            R = z["mcrates"][:, b:].reshape(-1, g["ncomp"])
            ll = ref.loglik(times, W, R, dev)
            ll_gap = max(ll_gap, ref.loglik_gap(ll, ll_ref[resid]))
    return ({"split_off": (float(split_off), limits["split_off"]),
             "loglik_gap": (ll_gap, limits["loglik_gap"]),
             "gmm_gap": (gmm_gap, limits["gmm_gap"]),
             "tau_gap": (tau_gap, limits["tau_gap"])}, failed)
