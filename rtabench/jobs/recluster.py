"""The recluster job: ``cluster --reprocess`` on stored ``gibbs`` results.

Set-up makes the tau cell's event table from the seed
(:func:`rtabench.jobs.tau.setup`) and runs one whole ``gibbs`` on it at
the configuration's settings, ``ParallelGibbs(events, cfg, root).run()``
on the card: the results tree a user has after ``gibbs``, each residue's
``gibbs_{niter}.npz`` holding the program's own chains. The sampler's
seed is the traffic's fixed ``gibbs_seed``, not the run's: the GMM's
iterations, and so a job's time, follow the chains (twice as long on
some seeds' chains as on others'), so every run reclusters the same
chains, its event table in the order its seed draws. It keeps a copy
of each stored file's times and chains, then warms up with one job. A job
is what ``cluster --reprocess`` does in process: ``ProcessProtein``
``reprocess`` (each residue's result reloaded and post-processed again:
the GMM, the votes, tau and the save), ``collect_results`` and
``write_data``. ``reprocess`` reads only the stored chains and times, so
every job has the same input. After each job, each residue's result file
is hard-linked, and the tau table moved, to names of the job's own (the
next save moves the file to ``.bak``; ``np.save`` would rewrite the
table's own inode), so the check judges every job once the window has
closed. Every run then reclusters the same chains; so that the check
sees other chains in every run, it has the program sample a second set
from the run's seed after the window and judges one more job on it.

The traced run wraps, from outside, ``ProcessProtein.reprocess`` (span
``reprocess``), each ``Gibbs.load`` (``reload``: the file read and the
residue's rebuild, the dedup of its times) and ``collect_results`` with
``write_data`` (``cluster``).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time

import numpy as np

from rtabench.jobs import tau
from rtabench.reference import tau as ref

# a job whose stored chains differ from set-up's: exact, so limit 0
CHAINS_OFF_LIMIT = 0


def _same(z, s, keys):
    """Whether the arrays ``keys`` of results ``z`` and ``s`` are equal,
    bitwise and in type."""
    return all(z[k].dtype == s[k].dtype and np.array_equal(z[k], s[k])
               for k in keys)


def setup(run):
    from basicrta_torch.protein.driver import ParallelGibbs
    state = tau.setup(run)
    cfg = dataclasses.replace(tau._gibbs_cfg(run),
                              seed=run.traffic["gibbs_seed"])
    root = os.path.join(run.workdir, "stored")
    dev = None if run.on_card else "cpu"
    out = ParallelGibbs(state["program"], cfg, root).run(
        engine=state["engine"], device=dev)
    tau._sync(run)
    paths = {int(lab[1:]): os.path.join(g.savedir, f"gibbs_{cfg.niter}.npz")
             for lab, g in out.items()}
    kept = os.path.join(run.workdir, "kept")
    os.makedirs(kept)
    state.update(cfg=cfg, root=root, dev=dev, paths=paths, kept=kept,
                 stored={r: tau.load_result(p) for r, p in paths.items()})
    return state


def _cluster(pp):
    pp.collect_results()
    return pp.write_data()


def _job(run, state, name):
    from basicrta_torch.protein.driver import ProcessProtein
    pp = ProcessProtein(cfg=state["cfg"], cutoff=run.config["cutoff"],
                        root=state["root"], device=state["dev"])
    pp.reprocess()
    table = _cluster(pp)
    tau._sync(run)
    base = os.path.join(state["kept"], name)
    for resid, path in state["paths"].items():
        os.link(path, f"{base}.{resid}.npz")
    os.replace(table, f"{base}.table.npy")


def warm(run, state):
    """One job, kept as ``warm``: the same loads, GMM, votes and save."""
    _job(run, state, "warm")


def run_job(run, state, index):
    try:
        _job(run, state, f"job{index}")
        return {"name": f"job{index}", "error": None}
    except Exception as e:  # noqa: BLE001 - a failed job is counted
        return {"name": f"job{index}", "error": f"{type(e).__name__}: {e}"}


def _wrap_load(spans, cls):
    """Span ``reload`` around each ``cls.load``: a classmethod, put back
    whole by ``spans.restore()``."""
    real = cls.__dict__["load"]

    def load(klass, path):
        t0 = time.time_ns()
        out = real.__func__(klass, path)
        spans.items.append(("reload", spans.job, t0, time.time_ns(), None))
        return out

    cls.load = classmethod(load)
    spans._patched.append((cls, "load", real))


def instrument(run, state):
    from basicrta_torch.protein import driver
    from basicrta_torch.sampler.gibbs import Gibbs
    run.spans.wrap(driver.ProcessProtein, "reprocess", "reprocess")
    run.spans.wrap(sys.modules[__name__], "_cluster", "cluster")
    _wrap_load(run.spans, Gibbs)


def _second_set(run, state):
    """A second chain set, sampled by the program from the run's seed
    into its own tree, and one job on it, after the window: (the stored
    files {resid: path}, their arrays before the job, the old files'
    inodes, the job's table path or None, the error or None)."""
    from basicrta_torch.protein.driver import ParallelGibbs, ProcessProtein
    root = os.path.join(run.workdir, "second")
    cfg = tau._gibbs_cfg(run)
    out = ParallelGibbs(tau.setup(run)["program"], cfg, root).run(
        engine=state["engine"], device=state["dev"])
    paths = {int(lab[1:]): os.path.join(g.savedir, f"gibbs_{cfg.niter}.npz")
             for lab, g in out.items()}
    del out
    before = {r: tau.load_result(p) for r, p in paths.items()}
    inodes = {os.stat(p).st_ino for p in paths.values()}
    try:
        pp = ProcessProtein(cfg=cfg, cutoff=run.config["cutoff"], root=root,
                            device=state["dev"])
        pp.reprocess()
        table = _cluster(pp)
        tau._sync(run)
        return paths, before, inodes, table, None
    except Exception as e:  # noqa: BLE001 - a failed job is counted
        return paths, before, inodes, None, f"{type(e).__name__}: {e}"


def _bad(table):
    """Whether a tau table holds a non-finite number or a CI with lo > hi."""
    return not np.isfinite(table).all() or np.any(table[:, 2] > table[:, 3])


def check(run, state):
    """{number: (value, limit)} and the failed jobs, by the tau cell's
    comparisons and limits, over the window's jobs and one more job on a
    second chain set that the program samples from the run's seed once
    the window has closed (:func:`_second_set`), so the post-processing
    is judged on other chains in every run. ``split_off``: residues whose
    stored times differ from the reference's split of the table, and job
    results whose times differ from the stored ones or whose residue the
    table lacks; ``chains_off``: job results, and set-up's stored files
    after the window, whose chains differ bitwise from those stored;
    ``loglik_gap``: both chain sets' log-likelihood posteriors against
    the reference sampler's; ``gmm_gap`` and ``tau_gap``: each job's
    labelling and table row by :func:`~rtabench.jobs.tau.judge_cluster`,
    each distinct (labels, row) of the window judged once, with the seed
    of its first job (a sample of ``judged_max`` of them, drawn from the
    seed, where there are more), and the second set's job. A job that
    raised, wrote a non-finite tau or a CI with lo > hi, or left a result
    file in place (no save of its own) counts as failed: the window's,
    and the second set's."""
    import torch

    c, chk = run.config, run.traffic["check"]
    g = c["gibbs"]
    limits = c["limits"]["tau"]
    split = ref.split_events(state["resids"], state["durations"])
    stored = state["stored"]
    resids = sorted(stored)
    b = g["burnin"] // g["g"]
    dev = "cuda" if run.on_card else "cpu"
    chains = ("mcweights", "mcrates")

    def read(path, before, r, rows):
        """(split_off, chains_off, z) of the result of residue ``r`` at
        ``path`` against ``before``, the file it reprocessed; z holds its
        table row, or is None where the table lacks the residue."""
        z = tau.load_result(path)
        off = (not _same(z, before, ("times",)), not _same(z, before, chains))
        del z["times"]
        if r not in rows:
            return off[0] + 1, off[1], None
        z["row"] = (rows[r][2], rows[r][1], rows[r][3])
        return off[0], off[1], z

    paths2, before2, inodes2, table2, error2 = _second_set(run, state)
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()

    split_off = sum(r not in stored
                    or not np.array_equal(np.sort(stored[r]["times"]),
                                          split[r])
                    for r in split)
    split_off += sum(not np.array_equal(np.sort(before2[r]["times"]),
                                        split[r]) for r in before2)
    chains_off = sum(not os.path.exists(p)
                     or not _same(tau.load_result(p), stored[r], chains)
                     for r, p in state["paths"].items())
    RW, RR = ref.sample([split[r] for r in resids], g["ncomp"],
                        1.0 / g["ncomp"], g["gamma_shape"], g["gamma_rate"],
                        chk["ref_sweeps"], chk["ref_burnin"], chk["ref_thin"],
                        run.seed, dev, torch.float32)
    ll_gap = 0.0
    for i, r in enumerate(resids):
        ll_ref = ref.loglik(split[r], RW[i], RR[i], dev)
        for z in (stored[r], before2.get(r)):
            if z is None:
                continue
            W = z["mcweights"][:, b:].reshape(-1, g["ncomp"])
            R = z["mcrates"][:, b:].reshape(-1, g["ncomp"])
            ll_gap = max(ll_gap, ref.loglik_gap(
                ref.loglik(split[r], W, R, dev), ll_ref))

    kept = state["kept"]
    inodes = {os.stat(os.path.join(kept, f"warm.{r}.npz")).st_ino
              for r in stored}
    failed, due = 0, {}
    for j, rec in enumerate(run.records):
        if rec["error"] is not None:
            print(f"{rec['name']} failed: {rec['error']}", file=sys.stderr)
            failed += 1
            continue
        base = os.path.join(kept, rec["name"])
        table = np.load(f"{base}.table.npy")
        rows = {int(row[0]): row for row in table}
        stale = False
        for r in resids:
            path = f"{base}.{r}.npz"
            ino = os.stat(path).st_ino
            stale |= ino in inodes
            inodes.add(ino)
            so, co, z = read(path, stored[r], r, rows)
            split_off, chains_off = split_off + so, chains_off + co
            if z is not None:
                key = (r, np.asarray(z.get("proc_labels", [])).tobytes(),
                       tuple(float(x) for x in z["row"]))
                due.setdefault(key, (j, z))
        failed += stale or _bad(table)
    keys = list(due)
    if len(keys) > chk["judged_max"]:
        pick = np.random.default_rng([run.seed, 2]).choice(
            len(keys), chk["judged_max"], replace=False)
        keys = [keys[i] for i in sorted(pick)]
    judged = [(key[0], *due[key]) for key in keys]
    print(f"judged {len(keys)} distinct results of {len(due)} among "
          f"{len(run.records)} jobs, and the second chain set's job",
          file=sys.stderr)

    j2 = len(run.records)
    if error2 is not None:
        print(f"the second chain set's job failed: {error2}",
              file=sys.stderr)
        failed += 1
    else:
        table = np.load(table2)
        rows = {int(row[0]): row for row in table}
        stale = False
        for r, path in paths2.items():
            stale |= os.stat(path).st_ino in inodes2
            so, co, z = read(path, before2[r], r, rows)
            split_off, chains_off = split_off + so, chains_off + co
            if z is not None:
                judged.append((r, j2, z))
        failed += stale or _bad(table)

    gmm_gap, tau_gap = 0.0, 0.0
    for r, j, z in judged:
        gg, tg = tau.judge_cluster(z, split[r], run, run.seed * 1009 + j,
                                   dev)
        gmm_gap, tau_gap = max(gmm_gap, gg), max(tau_gap, tg)
    return ({"split_off": (float(split_off), limits["split_off"]),
             "chains_off": (float(chains_off), CHAINS_OFF_LIMIT),
             "loglik_gap": (ll_gap, limits["loglik_gap"]),
             "gmm_gap": (gmm_gap, limits["gmm_gap"]),
             "tau_gap": (tau_gap, limits["tau_gap"])}, failed)
