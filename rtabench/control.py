"""The control of the tau cells, judged by the harness's own comparison.

    python3 -m rtabench.control --workload w313.tau --seeds 101,102,103
    python3 -m rtabench.control --workload w313.tau --seeds 1,2 --program
    python3 -m rtabench.control --workload w313.tau --seeds 1,2 --fault relabel

The control is the plain reference computed in bfloat16, the nearest
precision below the float32 the configuration states, put in the
program's place: ``ParallelGibbs`` and ``ProcessProtein`` of
``basicrta_torch.protein.driver``, the entries a tau job calls, give way
to :class:`ControlGibbs` and :class:`ControlProtein`, which sample every
residue's chains with the reference sampler, cluster them with the
reference ``cluster`` and write the same files, every step in bfloat16.
Each seed then runs :func:`rtabench.harness.run_cell` at the cell's own
size (set-up, a window of ``--seconds``, the check) and prints one JSON
line: ``correct`` and each number beside its limit. The control has to
come out not correct. With ``--program`` the program stays in place: the
sound readings of many seeds in one process. With ``--fault relabel`` the
program runs with :func:`relabel`, a fault planted in its clustering.

The benchmark's runs never run this; ``rtabench/tests`` runs it at a test
size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from rtabench.reference import tau as ref

DTYPE = torch.bfloat16


def _control_classes(gibbs, device):
    """The two entries of a tau job, as the reference in ``DTYPE``."""

    class ControlGibbs:
        def __init__(self, events, cfg, root="."):
            self.events, self.cfg, self.root = events, cfg, root

        def run(self, **_):
            cfg = self.cfg
            split = ref.split_events(self.events.sel1_resids,
                                     self.events.durations)
            K, b = cfg.ncomp, cfg.burnin // cfg.g
            for resid, times in split.items():
                W, R = ref.sample([times] * cfg.n_chains, K, 1.0 / K,
                                  cfg.gamma_shape, cfg.gamma_rate,
                                  cfg.niter, 0, cfg.g, cfg.seed, device,
                                  DTYPE)
                labels, tau = ref.cluster_tau(W[0, b:], R[0, b:], times,
                                              gibbs, cfg.seed, device, DTYPE)
                out = os.path.join(self.root,
                                   f"basicrta-{self.events.meta.cutoff}",
                                   f"X{resid}")
                os.makedirs(out, exist_ok=True)
                np.savez(os.path.join(out, f"gibbs_{cfg.niter}.npz"),
                         times=times, mcweights=W.astype(np.float32),
                         mcrates=R.astype(np.float32),
                         proc_labels=labels, tau=np.asarray(tau))

    class ControlProtein:
        def __init__(self, cfg, cutoff=7.0, root=".", device=None, **_):
            self.cfg, self.cutoff, self.root = cfg, cutoff, root

        def get_taus(self):
            base = os.path.join(self.root, f"basicrta-{self.cutoff}")
            self.rows = []
            for d in sorted(os.listdir(base)):
                with np.load(os.path.join(
                        base, d, f"gibbs_{self.cfg.niter}.npz")) as z:
                    lo, tau, hi = z["tau"]
                self.rows.append([int(d[1:]), tau, lo, hi])

        def write_data(self):
            if not hasattr(self, "rows"):
                self.get_taus()
            out = os.path.join(self.root, "tausout.npy")
            np.save(out, np.asarray(self.rows, np.float64))
            return out

    return ControlGibbs, ControlProtein


def relabel(real):
    """The program's batched GMM ``real`` with every other pair's label
    set to the first cluster's: a wrong clustering."""
    def wrong(train, train_w, data, n_components, *a, **k):
        labels, params = real(train, train_w, data, n_components, *a, **k)
        labels = labels.clone()
        labels[:, ::2] = 0
        return labels, params
    return wrong


def readings(workload, seed, seconds, program=False, device="cuda",
             fault=None, **run_kw):
    """(result, checks) of one run of ``workload``: the control in the
    program's place, or with ``program`` the program itself, or with
    ``fault`` 'relabel' the program with :func:`relabel` planted."""
    from basicrta_torch.postprocess import batched
    from basicrta_torch.protein import driver

    from rtabench import harness

    if fault == "relabel":
        real = batched.fit_predict_batched
        batched.fit_predict_batched = relabel(real)
        try:
            return harness.run_cell(workload, seed, seconds, False,
                                    device=device, **run_kw)
        finally:
            batched.fit_predict_batched = real
    if program:
        return harness.run_cell(workload, seed, seconds, False,
                                device=device, **run_kw)
    bench = run_kw.get("bench") or harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json"))
    _, config, _ = harness.find_cell(bench, workload)
    config = {**config, **(run_kw.get("config_override") or {})}
    saved = driver.ParallelGibbs, driver.ProcessProtein
    driver.ParallelGibbs, driver.ProcessProtein = _control_classes(
        config["gibbs"], device)
    try:
        return harness.run_cell(workload, seed, seconds, False,
                                device=device, **run_kw)
    finally:
        driver.ParallelGibbs, driver.ProcessProtein = saved


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m rtabench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault", choices=("relabel",))
    args = p.parse_args(argv)
    from rtabench import harness
    harness._cache_env(harness.ROOT)
    if not torch.cuda.is_available():
        print("the controls are read on the card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        result, checks = readings(args.workload, int(s), args.seconds,
                                  args.program, fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "control": not (args.program or args.fault),
                          "fault": args.fault,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
