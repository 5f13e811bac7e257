"""The controls of the recluster cells, judged by the harness's own
comparison.

    python3 -m rtabench.control_recluster --workload w313.recluster --seeds 1,2

A recluster job's timed path is ``ProcessProtein``'s ``reprocess``,
``collect_results`` and ``write_data``; set-up's ``gibbs`` makes its input.
So a control puts only :func:`control_protein` in the program's place:
``reprocess`` clusters each stored chain with the plain reference in
bfloat16, the nearest precision below the float32 the configuration
states, and saves the result as the program does (the old file moved to
``.bak``). Set-up, and the check's second chain set, still sample with
the program. Two controls: ``bfloat16`` rounds the chains first, so
the pair filter, the GMM, the votes and tau all run in bfloat16;
``bfloat16_after_filter`` filters the pairs in the chains' own float32
and runs the GMM, the votes and tau in bfloat16. Each seed runs
:func:`rtabench.harness.run_cell` at the cell's own size once a control
and prints one JSON line: ``correct`` and each number beside its limit.
Both have to come out not correct. The program's own readings, and its
clustering broken, are :mod:`rtabench.control`'s ``--program`` and
``--fault relabel``, which serve any workload.

The benchmark's runs never run this; ``rtabench/tests`` runs it at a test
size.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from rtabench import control
from rtabench.reference import tau as ref

KINDS = ("bfloat16", "bfloat16_after_filter")


def _cluster_after_filter(W, R, times, gibbs, seed, device, dtype):
    """:func:`~rtabench.reference.tau.cluster_tau` with the pair filter
    on the chains as stored and every later step in ``dtype``."""
    above, C, data, train = ref.cluster_inputs(W, R, len(times), gibbs)
    labels = ref.gmm_labels(np.log(data[train]), np.log(data), C,
                            gibbs["gmm_n_init"], gibbs["gmm_max_iter"],
                            gibbs["gmm_tol"], seed, device, dtype)
    return labels, ref.taus(W, R, times, above, labels, C, gibbs, device,
                            dtype)[0]


def control_protein(gibbs, device, kind="bfloat16"):
    """:class:`rtabench.control`'s ``ControlProtein`` with a
    ``reprocess`` in ``control.DTYPE``, as ``kind`` says."""
    _, base = control._control_classes(gibbs, device)
    cluster = (ref.cluster_tau if kind == "bfloat16"
               else _cluster_after_filter)

    class ControlProtein(base):
        def _paths(self):
            # the program's tree also holds ``.checkpoints``, which the
            # base's listing would take for a residue
            return sorted(glob.glob(os.path.join(
                self.root, f"basicrta-{self.cutoff}", "*",
                f"gibbs_{self.cfg.niter}.npz")))

        def reprocess(self):
            b = self.cfg.burnin // self.cfg.g
            for path in self._paths():
                with np.load(path, allow_pickle=False) as z:
                    times, W, R = z["times"], z["mcweights"], z["mcrates"]
                labels, tau = cluster(W[0, b:], R[0, b:], times, gibbs,
                                      self.cfg.seed, device, control.DTYPE)
                os.replace(path, path + ".bak")
                np.savez(path, times=times, mcweights=W, mcrates=R,
                         proc_labels=labels, tau=np.asarray(tau))

        def collect_results(self):
            self.rows = []
            for path in self._paths():
                with np.load(path) as z:
                    lo, tau, hi = z["tau"]
                resid = int(os.path.basename(os.path.dirname(path))[1:])
                self.rows.append([resid, tau, lo, hi])

    return ControlProtein


def readings(workload, seed, seconds, device="cuda", kind="bfloat16",
             **run_kw):
    """(result, checks) of one run of ``workload`` with the control
    ``kind`` in the program's place."""
    from basicrta_torch.protein import driver

    from rtabench import harness

    bench = run_kw.get("bench") or harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json"))
    _, config, _ = harness.find_cell(bench, workload)
    config = {**config, **(run_kw.get("config_override") or {})}
    saved = driver.ProcessProtein
    driver.ProcessProtein = control_protein(config["gibbs"], device, kind)
    try:
        return harness.run_cell(workload, seed, seconds, False,
                                device=device, **run_kw)
    finally:
        driver.ProcessProtein = saved


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m rtabench.control_recluster")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    from rtabench import harness
    harness._cache_env(harness.ROOT)
    if not torch.cuda.is_available():
        print("the controls are read on the card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        for kind in KINDS:
            result, _ = readings(args.workload, int(s), args.seconds,
                                 kind=kind)
            print(json.dumps({"workload": args.workload, "seed": int(s),
                              "control": kind, **{k: result[k] for k in (
                                  "correct", "attempted", "failed",
                                  "checks")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
