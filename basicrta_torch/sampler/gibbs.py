"""Per-residue Gibbs sampler API.

Port of ``basicrta_tpu.sampler.gibbs.Gibbs`` (reference gibbs.py:91-381):
construct with residence times, ``run()`` the sampler, ``process_gibbs()``
the posterior, ``estimate_tau()`` the slowest process (``estimate_tau_all()``
every non-noise one), ``save()`` and ``load()`` artifacts, and the
per-residue figures (``basicrta_torch.plots``, which needs matplotlib). The artifact layout (NPZ arrays + JSON ``_meta``
under ``basicrta-{cutoff}/{residue}/gibbs_{niter}.npz``) is the JAX
package's, so an artifact written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional

import numpy as np
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops.surv import infer_timestep, survival_function
from basicrta_torch.postprocess.clustering import (ClusterResult,
                                                   process_samples)
from basicrta_torch.postprocess.tau import (AllNoiseError, estimate_params,
                                            estimate_tau, estimate_tau_all)
from basicrta_torch.sampler.batch import resolve_engine, run_residues
from basicrta_torch.sampler.kernels import (compute_tiers, dedup_times,
                                            run_chains)

MODES = ("collapsed", "dense")


class Gibbs:
    """Gibbs sampler for the exponential mixture of one residue's times::

        g = Gibbs(times, residue='W313', cutoff=7.0)
        g.run()
        g.process_gibbs()
        lo, tau, hi = g.estimate_tau()
    """

    def __init__(self, times: Optional[np.ndarray] = None,
                 residue: Optional[str] = None, cutoff: Optional[float] = None,
                 cfg: GibbsConfig = GibbsConfig(), root: str = "."):
        self.cfg = cfg
        self.residue = residue
        self.cutoff = cutoff
        self.root = root
        self.times = None if times is None else np.asarray(times, np.float64)
        self.device = None  # where run() sampled; post-processing follows
        self.ts = infer_timestep(self.times) if times is not None else None
        self.mcweights: Optional[np.ndarray] = None  # (chains, S, K)
        self.mcrates: Optional[np.ndarray] = None
        self.t = self.s = None          # the empirical survival function
        self.processed: Optional[ClusterResult] = None
        self.parameters = None          # (lmode, 2) point estimates
        self.intervals = None           # (2, lmode, 2) CIs
        self.tau = None                 # (lo, max, hi)
        if self.times is not None:
            self.t, self.s = survival_function(self.times, self.ts)
            self._values, self._counts = dedup_times(self.times)

    def __getitem__(self, item):
        return getattr(self, item)

    def _residue_fold(self) -> int:
        """Stable per-residue seed fold (``hash(str)`` is salted)."""
        return zlib.crc32(str(self.residue).encode()) & 0x7FFFFFFF

    @property
    def savedir(self) -> str:
        return os.path.join(self.root, f"basicrta-{self.cutoff}",
                            str(self.residue))

    def run(self, engine: Optional[str] = None, device=None,
            save: bool = True, mode: Optional[str] = None) -> "Gibbs":
        """Sample ``cfg.n_chains`` chains.

        By default they run as lanes of a bucket on ``engine``: the fused
        kernel ('cuda', the default, on the card), its plain version
        ('torch', or a CPU ``device``) or the reference collapsed sweep
        ('collapsed'); see ``resolve_engine``. ``mode`` runs the reference
        chains directly instead, on ``device`` (default the card):
        'collapsed' (the deduplicated sweep, values in multiplicity
        order) or 'dense' (the literal per-event sweep)."""
        if mode is None:
            engine, self.device = resolve_engine(engine, device)
            samples = run_residues({str(self.residue): self.times},
                                   self.cfg, n_chains=self.cfg.n_chains,
                                   engine=engine, device=self.device)
            W, R = samples[str(self.residue)]
        else:
            if mode not in MODES:
                raise ValueError(f"unknown mode {mode!r}; use one of "
                                 f"{MODES} or None")
            if engine is not None:
                raise ValueError(f"mode {mode!r} runs the reference chains "
                                 f"and takes no engine (got {engine!r})")
            _, self.device = resolve_engine("collapsed", device)
            tiers = None
            if mode == "collapsed":
                # the thinned (w, r) samples do not depend on the order
                order, tiers = compute_tiers(self._counts)
                data, aux = self._values[order], self._counts[order]
            else:
                data, aux = self.times, None
            data, aux = (None if a is None else torch.as_tensor(
                a, dtype=torch.float32, device=self.device)
                for a in (data, aux))
            W, R = run_chains(self._generator(0), data, aux, self.cfg, mode,
                              self.cfg.n_chains, tiers)
            W, R = W.cpu().numpy(), R.cpu().numpy()
        self.mcweights, self.mcrates = W, R
        if save:
            self.save()
        return self

    def _generator(self, offset: int, device=None) -> torch.Generator:
        """Seeded generator of one post-processing stage of this residue,
        on ``device``, else where :meth:`run` sampled, else the card."""
        _, device = resolve_engine(
            None, device if device is not None else self.device)
        gen = torch.Generator(device=device)
        gen.manual_seed((self.cfg.seed + offset) * 1_000_003
                        + self._residue_fold())
        return gen

    def process_gibbs(self, chain=0, save: bool = True,
                      device=None) -> "Gibbs":
        """Posterior filtering, clustering and parameter estimation
        (reference gibbs.py:275-308); ``chain='pooled'`` pools the
        post-burn-in samples of all chains."""
        if chain == "pooled" and self.mcweights.shape[0] > 1:
            b = self.cfg.burnin_samples
            W = np.concatenate([self.mcweights[0][:b]]
                               + [c[b:] for c in self.mcweights])
            R = np.concatenate([self.mcrates[0][:b]]
                               + [c[b:] for c in self.mcrates])
        else:
            idx = 0 if chain == "pooled" else chain
            W, R = self.mcweights[idx], self.mcrates[idx]
        self.processed = process_samples(self._generator(1, device), W, R,
                                         self._values, self._counts,
                                         self.cfg)
        self.parameters, self.intervals = estimate_params(self.processed)
        if save:
            self.save()
        return self

    def estimate_tau(self):
        """(ci_lo, tau_max, ci_hi) of the slowest non-noise process."""
        if self.processed is None:
            self.process_gibbs()
        self.tau = estimate_tau(self.processed, self.cfg.noise_cutoff,
                                self.parameters)
        return list(self.tau)

    def estimate_tau_all(self):
        """Rows ``[cluster, ci_lo, tau_max, ci_hi]`` for every non-noise
        cluster, slowest first."""
        if self.processed is None:
            self.process_gibbs()
        return estimate_tau_all(self.processed, self.cfg.noise_cutoff,
                                self.parameters)

    def diagnostics(self) -> dict:
        """Split-R̂ and bulk ESS of the live components over the chains."""
        from basicrta_torch.ops.diagnostics import convergence_report
        return convergence_report(
            self.mcweights, self.mcrates,
            burnin_samples=self.cfg.burnin_samples,
            wcutoff=self.cfg.wcutoff(len(self.times)))

    def pindicator_per_event(self) -> np.ndarray:
        """(N, lmode) membership probabilities of the unique values
        broadcast back to the events (events of equal residence time are
        exchangeable)."""
        if self.processed is None:
            self.process_gibbs()
        pv = self.processed.pindicator_values
        return pv[np.searchsorted(self._values, self.times)]

    def save(self) -> str:
        """Persist raw + processed state as NPZ (previous file -> .bak)."""
        os.makedirs(self.savedir, exist_ok=True)
        path = os.path.join(self.savedir, f"gibbs_{self.cfg.niter}.npz")
        if os.path.exists(path):
            os.replace(path, path + ".bak")
        arrays = {
            "times": self.times,
            "mcweights": self.mcweights if self.mcweights is not None
            else np.zeros(0),
            "mcrates": self.mcrates if self.mcrates is not None
            else np.zeros(0),
        }
        if self.processed is not None:
            p = self.processed
            arrays.update(
                proc_labels=p.labels, proc_data=p.data,
                proc_inds_row=p.inds[0], proc_inds_col=p.inds[1],
                proc_pindicator=p.pindicator_values,
                proc_presorts=p.presorts,
                parameters=self.parameters, intervals=self.intervals)
            if self.tau is not None:
                arrays["tau"] = np.asarray(self.tau)
        meta = {"residue": self.residue, "cutoff": self.cutoff,
                "ts": self.ts, "cfg": self.cfg.to_json(),
                "lmode": None if self.processed is None
                else int(self.processed.lmode)}
        np.savez_compressed(path, _meta=json.dumps(meta), **arrays)
        return path

    @classmethod
    def load(cls, path: str) -> "Gibbs":
        """Rehydrate from :meth:`save` output of either package.

        A reference-package ``gibbs_{niter}.pkl`` loads too (chains and
        configuration; re-run :meth:`process_gibbs` for processed state):
        see :mod:`basicrta_torch.io.legacy`.
        """
        if path.endswith(".pkl"):
            from basicrta_torch.io.legacy import load_reference_gibbs
            return load_reference_gibbs(
                path, root=os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(path)))))
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["_meta"]))
            g = cls(times=z["times"], residue=meta["residue"],
                    cutoff=meta["cutoff"],
                    cfg=GibbsConfig.from_json(meta["cfg"]),
                    root=os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(path)))))
            if z["mcweights"].size:
                g.mcweights = z["mcweights"]
                g.mcrates = z["mcrates"]
            if "proc_labels" in z:
                g.processed = ClusterResult(
                    lmode=meta["lmode"], labels=z["proc_labels"],
                    inds=(z["proc_inds_row"], z["proc_inds_col"]),
                    data=z["proc_data"],
                    pindicator_values=z["proc_pindicator"],
                    presorts=z["proc_presorts"])
                g.parameters = z["parameters"]
                g.intervals = z["intervals"]
            if "tau" in z:
                g.tau = tuple(z["tau"])
        return g

    # ------------------------------------------------------------------ #
    def cluster(self, chain=0, method: str = "GaussianMixture", device=None,
                **kwargs) -> "Gibbs":
        """Re-run the posterior clustering only (reference
        gibbs.py:221-273). 'GaussianMixture' is the port's own EM; another
        ``sklearn.mixture`` class name (e.g. 'BayesianGaussianMixture')
        labels the samples with scikit-learn. Remaining kwargs override
        GibbsConfig fields (or, for scikit-learn, the model's)."""
        if method != "GaussianMixture":
            return self._cluster_sklearn(chain, method, device, **kwargs)
        if kwargs:
            import dataclasses
            self.cfg = dataclasses.replace(self.cfg, **kwargs)
        return self.process_gibbs(chain=chain, save=False, device=device)

    def _cluster_sklearn(self, chain, method, device=None, **kwargs):
        """Label the surviving posterior pairs with an sklearn.mixture
        model, then vote and sort as :meth:`process_gibbs` does."""
        from sklearn import mixture

        from basicrta_torch.postprocess.clustering import (
            _label_matrix, accumulate_cluster_votes, component_counts,
            gather_cluster_data, select_lmode, sort_labels_by_rate)
        idx = 0 if chain == "pooled" else chain
        b = self.cfg.burnin_samples
        W = np.asarray(self.mcweights[idx])[b:]
        R = np.asarray(self.mcrates[idx])[b:]
        wcut = self.cfg.wcutoff(len(self.times))
        lmode = select_lmode(component_counts(W, wcut))
        data, inds, train = gather_cluster_data(W, R, wcut, lmode)
        clu = getattr(mixture, method)(
            n_components=lmode,
            **{k: v for k, v in kwargs.items() if k != "n_components"})
        clu.fit(np.log(train))
        labels = clu.predict(np.log(data)).astype(np.int32)
        res = ClusterResult(lmode=lmode, labels=labels, inds=inds,
                            data=data)
        votes = accumulate_cluster_votes(
            self._generator(2, device), W, R, self._values, self._counts,
            _label_matrix(inds, labels, W.shape), lmode)
        denom = votes.sum(axis=1, keepdims=True)
        res.pindicator_values = votes / np.maximum(denom, 1e-30)
        self.processed = sort_labels_by_rate(res, self.cfg.noise_cutoff)
        self.parameters, self.intervals = estimate_params(self.processed)
        return self

    # the per-residue figures (basicrta_torch.plots; matplotlib)
    def result_plot(self, **kwargs):
        """Cluster scatter figure (reference gibbs.py:310-319)."""
        from basicrta_torch.plots import plot_cluster_scatter
        return plot_cluster_scatter(self, **kwargs)

    def plot_surv(self, **kwargs):
        """Survival function with the mixture's components
        (reference gibbs.py:717-778)."""
        from basicrta_torch.plots import plot_surv
        return plot_surv(self, **kwargs)

    def plot_gibbs(self, **kwargs):
        """Thinned traces (reference gibbs.py:640-665)."""
        from basicrta_torch.plots import plot_gibbs_traces
        return plot_gibbs_traces(self, **kwargs)

    def plot_hist(self, **kwargs):
        """Posterior histograms per cluster (reference gibbs.py:427-638)."""
        from basicrta_torch.plots import plot_hist_results
        return plot_hist_results(self, **kwargs)

    def plot_tau_hist(self, **kwargs):
        """Tau histogram of the slowest cluster
        (reference gibbs.py:383-425)."""
        from basicrta_torch.plots import plot_tau_hist
        return plot_tau_hist(self, **kwargs)

    def mixture_and_plot(self, **kwargs):
        """Train/validate/all clustering figure sets
        (reference util.py:694-1198)."""
        from basicrta_torch.plots import mixture_and_plot
        return mixture_and_plot(self, **kwargs)

    def make_residue_plots(self, comps=None):
        """Point-estimate fits, posterior histograms and traces
        (reference util.py:384-400)."""
        from basicrta_torch.plots import make_residue_plots
        return make_residue_plots(self, comps)


def run_residue(times, residue, cutoff, cfg: GibbsConfig = GibbsConfig(),
                root: str = ".", engine: Optional[str] = None,
                device=None) -> Gibbs:
    """Construct, run, post-process and save one residue (the unit of work
    the reference fans out per process, util.py:475-485); a residue whose
    clusters are all noise records tau (0, 0, 0)."""
    g = Gibbs(times, residue=residue, cutoff=cutoff, cfg=cfg, root=root)
    g.run(engine=engine, device=device, save=False)
    g.process_gibbs(save=False)
    try:
        g.estimate_tau()
    except AllNoiseError:
        g.tau = (0.0, 0.0, 0.0)
    g.save()
    return g
