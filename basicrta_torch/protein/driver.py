"""All-residue sampling driver and cross-residue tau aggregation.

Port of ``basicrta_tpu.protein.driver`` (reference gibbs.py:20-88 and
cluster.py:15-192): ``ParallelGibbs`` runs every residue's chains as lanes
of the fused sweep kernels, ``finish_batch`` post-processes all residues
in bucketed batches, and ``ProcessProtein`` collects the per-residue
results into the protein's tau table.
"""

from __future__ import annotations

import os
import re
import warnings
from glob import glob
from typing import Dict, List, Optional, Union

import numpy as np

from basicrta_tpu.ops.surv import ci_bars
from basicrta_torch.config import GibbsConfig
from basicrta_torch.contacts.records import ContactEvents
from basicrta_torch.postprocess.batched import process_residues_batched
from basicrta_torch.postprocess.tau import AllNoiseError, estimate_params
from basicrta_torch.sampler.batch import run_residues
from basicrta_torch.sampler.gibbs import Gibbs


def finish_batch(gibbs_by_label: Dict[str, Gibbs], chain=0,
                 save: bool = True, device=None) -> None:
    """Post-process every residue's samples in bucketed batches
    (:func:`~basicrta_torch.postprocess.batched.process_residues_batched`)
    and fill each Gibbs with its clusters, parameters and tau; a residue
    whose clusters are all noise records tau (0, 0, 0)."""
    if not gibbs_by_label:
        return
    items = {lab: (g.mcweights, g.mcrates, g._values, g._counts)
             for lab, g in gibbs_by_label.items()}
    cfg = next(iter(gibbs_by_label.values())).cfg
    results = process_residues_batched(items, cfg, chain=chain,
                                       device=device)
    for lab, g in gibbs_by_label.items():
        g.processed = results[lab]
        g.parameters, g.intervals = estimate_params(g.processed)
        try:
            g.estimate_tau()
        except AllNoiseError:
            g.tau = (0.0, 0.0, 0.0)
        if save:
            g.save()


def cutoff_from_filename(path: str) -> float:
    """Analysis cutoff from a ``contacts_{cutoff}.npz`` filename."""
    stem = os.path.basename(path)
    for ext in (".npz", ".pkl", ".npy"):
        if stem.endswith(ext):
            stem = stem[: -len(ext)]
    return float(stem.split("_")[-1])


def residue_labels_for(events: ContactEvents,
                       resids: np.ndarray) -> List[str]:
    """Residue labels 'X{resid}', the JAX package's fallback when no
    topology is available; topology-derived labels like 'W313' come with
    the port of ``io/``."""
    if events.meta.top and os.path.exists(events.meta.top):
        warnings.warn(f"topology labels are not read yet ({events.meta.top}"
                      "); result directories will be named X<resid>",
                      stacklevel=2)
    return [f"X{r}" for r in resids]


class ParallelGibbs:
    """Run Gibbs samplers for every sel1 residue in a contact-event table.

    :param contacts: path to a ``contacts_{cutoff}.npz`` event table or a
        ContactEvents instance.
    """

    def __init__(self, contacts: Union[str, ContactEvents],
                 cfg: GibbsConfig = GibbsConfig(), root: str = "."):
        if isinstance(contacts, str):
            if not os.path.exists(contacts):
                raise FileNotFoundError(
                    f"contacts file not found: {contacts}")
            self.cutoff = cutoff_from_filename(contacts)
            self.events = ContactEvents.load(contacts)
            if self.events.meta.cutoff is not None:
                self.cutoff = self.events.meta.cutoff
        else:
            self.events = contacts
            self.cutoff = self.events.meta.cutoff
            if self.cutoff is None:
                raise ValueError(
                    "the ContactEvents instance carries no cutoff "
                    "metadata (meta.cutoff is None); set events.meta.cutoff "
                    "or load from a contacts_{cutoff} file")
        self.cfg = cfg
        self.root = root

    def run(self, run_resids=None, engine: str = "auto", device=None,
            progress_cb=None) -> Dict[str, Gibbs]:
        """Sample all residues (or ``run_resids``) as lanes of the fused
        kernels on the engine's layout (see ``run_residues``), then
        post-process them in bucketed batches."""
        all_resids = np.unique(self.events.sel1_resids)
        if run_resids is None:
            resids = all_resids
        else:
            resids = all_resids[np.isin(all_resids,
                                        np.atleast_1d(run_resids))]
        labels = residue_labels_for(self.events, resids)
        per_resid = self.events.split_by_residue(resids)
        times = {lab: per_resid[int(r)] for lab, r in zip(labels, resids)}
        # too few events for the 10/N weight cutoff: skipped with the
        # sentinel missing_residues honours
        min_events = max(2, int(self.cfg.weight_cut_events))
        for lab in list(times):
            if len(times[lab]) < min_events:
                d = os.path.join(self.root, f"basicrta-{self.cutoff}", lab)
                os.makedirs(d, exist_ok=True)
                open(os.path.join(d, ".dataset_too_small"), "w").close()
                del times[lab]
        ckpt_dir = os.path.join(self.root, f"basicrta-{self.cutoff}",
                                ".checkpoints")
        samples = run_residues(times, self.cfg, n_chains=self.cfg.n_chains,
                               checkpoint_dir=ckpt_dir, engine=engine,
                               device=device, progress_cb=progress_cb)
        out: Dict[str, Gibbs] = {}
        for lab, (W, R) in samples.items():
            g = Gibbs(times[lab], residue=lab, cutoff=self.cutoff,
                      cfg=self.cfg, root=self.root)
            g.mcweights, g.mcrates = W, R
            out[lab] = g
        finish_batch(out, device=device)
        return out


class ProcessProtein:
    """Collect per-residue results and aggregate tau across the protein
    (reference cluster.py:15-192)."""

    def __init__(self, cfg: GibbsConfig = GibbsConfig(), cutoff: float = 7.0,
                 root: str = "."):
        self.cfg = cfg
        self.cutoff = cutoff
        self.root = root
        self.residues: Dict[str, Optional[str]] = {}

    def __getitem__(self, item):
        return getattr(self, item)

    @property
    def _basedir(self) -> str:
        return os.path.join(self.root, f"basicrta-{self.cutoff}")

    def _result_dirs(self) -> List[str]:
        dirs = [d for d in glob(os.path.join(self._basedir, "?[0-9]*"))
                if re.match(r"^[A-Za-z]\d+$", os.path.basename(d))]
        return sorted(dirs, key=lambda d: int(os.path.basename(d)[1:]))

    def collect_results(self) -> Dict[str, Optional[str]]:
        """Residue label -> result path (None when missing), by resid."""
        self.residues = {}
        for adir in self._result_dirs():
            path = os.path.join(adir, f"gibbs_{self.cfg.niter}.npz")
            self.residues[os.path.basename(adir)] = (
                path if os.path.exists(path) else None)
        return self.residues

    def missing_residues(self) -> List[str]:
        """Residues with no result and no '.dataset_too_small' sentinel."""
        if not self.residues:
            self.collect_results()
        return [label for label, path in self.residues.items()
                if path is None and not os.path.exists(os.path.join(
                    self._basedir, label, ".dataset_too_small"))]

    def reprocess(self, device=None) -> None:
        """Re-run post-processing for every residue with results."""
        if not self.residues:
            self.collect_results()
        loaded = {}
        for label, path in self.residues.items():
            if path is not None:
                g = Gibbs.load(path)
                g.root = self.root
                loaded[label] = g
        finish_batch(loaded, device=device)

    def get_taus(self):
        """(taus, bars): slowest-process tau and CI offsets per residue;
        zeros where results are missing or degenerate."""
        if not self.residues:
            self.collect_results()
        taus = []
        for label, path in self.residues.items():
            if path is None:
                taus.append([0.0, 0.0, 0.0])
                continue
            try:
                g = Gibbs.load(path)
                g.root = self.root
                taus.append(list(g.tau) if g.tau is not None
                            else g.estimate_tau())
            except (AllNoiseError, KeyError, ValueError):
                taus.append([0.0, 0.0, 0.0])
        taus = np.asarray(taus, np.float64).reshape(-1, 3)
        return taus[:, 1], ci_bars(taus)

    def write_data(self, fname: str = "tausout") -> str:
        """[resid, tau, CI_lo, CI_hi] table as .npy (cluster.py:122-134)."""
        taus, bars = self.get_taus()
        resids = np.array([int(label[1:]) for label in self.residues])
        data = np.stack((resids, taus, taus - bars[0], taus + bars[1])).T
        out = os.path.join(self.root, f"{fname}.npy")
        np.save(out, data)
        return out
