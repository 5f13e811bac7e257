"""Per-residue Gibbs sampler API.

Port of ``basicrta_tpu.sampler.gibbs.Gibbs`` (reference gibbs.py:91-381):
construct with residence times, ``run()`` the sampler, ``process_gibbs()``
the posterior, ``estimate_tau()`` the slowest process, ``save()`` and
``load()`` artifacts. The artifact layout (NPZ arrays + JSON ``_meta``
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

from basicrta_tpu.ops.surv import infer_timestep
from basicrta_torch.config import GibbsConfig
from basicrta_torch.postprocess.clustering import (ClusterResult,
                                                   process_samples)
from basicrta_torch.postprocess.tau import estimate_params, estimate_tau
from basicrta_torch.sampler.batch import resolve_engine, run_residues
from basicrta_torch.sampler.kernels import dedup_times


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
        self.ts = infer_timestep(self.times) if times is not None else None
        self.mcweights: Optional[np.ndarray] = None  # (chains, S, K)
        self.mcrates: Optional[np.ndarray] = None
        self.processed: Optional[ClusterResult] = None
        self.parameters = None          # (lmode, 2) point estimates
        self.intervals = None           # (2, lmode, 2) CIs
        self.tau = None                 # (lo, max, hi)
        if self.times is not None:
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

    def run(self, engine: str = "auto", device=None,
            save: bool = True) -> "Gibbs":
        """Sample ``cfg.n_chains`` chains as lanes of the fused kernel
        ('cuda'), or its plain version ('torch'); 'auto' picks by device."""
        samples = run_residues({str(self.residue): self.times}, self.cfg,
                               n_chains=self.cfg.n_chains, engine=engine,
                               device=device)
        self.mcweights, self.mcrates = samples[str(self.residue)]
        if save:
            self.save()
        return self

    def _generator(self, offset: int, device=None) -> torch.Generator:
        """Seeded generator of one post-processing stage of this residue."""
        _, device = resolve_engine("auto", device)
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

    def diagnostics(self) -> dict:
        """Split-R̂ and bulk ESS of the live components over the chains."""
        from basicrta_tpu.ops.diagnostics import convergence_report
        return convergence_report(
            self.mcweights, self.mcrates,
            burnin_samples=self.cfg.burnin_samples,
            wcutoff=self.cfg.wcutoff(len(self.times)))

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
        """Rehydrate from :meth:`save` output of either package."""
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
