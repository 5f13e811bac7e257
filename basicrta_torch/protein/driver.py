"""All-residue sampling driver and cross-residue tau aggregation.

Port of ``basicrta_tpu.protein.driver`` (reference gibbs.py:20-88 and
cluster.py:15-192): ``ParallelGibbs`` runs every residue's chains as lanes
of the fused sweep kernels (or one residue after another), ``finish_batch``
post-processes all residues in bucketed batches, and ``ProcessProtein``
collects the per-residue results into the protein's tau tables (slowest
process and every cluster), the convergence table, the tau-vs-residue
figures and the b-factor-coloured structure. ``finish_batch`` is the
span ``post.batch`` of :mod:`basicrta_torch.spans`, with ``post.tau``
and ``post.save`` a residue inside it.
"""

from __future__ import annotations

import os
import re
import warnings
from glob import glob
from typing import Dict, List, Optional, Union

import numpy as np

from basicrta_torch import spans
from basicrta_torch.config import GibbsConfig
from basicrta_torch.contacts.records import ContactEvents
from basicrta_torch.ops.surv import ci_bars
from basicrta_torch.postprocess.batched import process_residues_batched
from basicrta_torch.postprocess.tau import AllNoiseError, estimate_params
from basicrta_torch.sampler.batch import resolve_engine, run_residues
from basicrta_torch.sampler.gibbs import Gibbs, run_residue


def finish_batch(gibbs_by_label: Dict[str, Gibbs], chain=0,
                 save: bool = True, device=None, sharding=None) -> None:
    """Post-process every residue's samples in bucketed batches
    (:func:`~basicrta_torch.postprocess.batched.process_residues_batched`)
    on ``device`` (default the card), or with the residues split over the
    lane devices of ``sharding``, and fill each Gibbs with its clusters,
    parameters and tau; a residue whose clusters are all noise records
    tau (0, 0, 0)."""
    if not gibbs_by_label:
        return
    with spans.span("post.batch"):
        items = {lab: (g.mcweights, g.mcrates, g._values, g._counts)
                 for lab, g in gibbs_by_label.items()}
        cfg = next(iter(gibbs_by_label.values())).cfg
        results = process_residues_batched(items, cfg, chain=chain,
                                           device=device, sharding=sharding)
        for lab, g in gibbs_by_label.items():
            g.processed = results[lab]
            with spans.span("post.tau"):
                g.parameters, g.intervals = estimate_params(g.processed)
                try:
                    g.estimate_tau()
                except AllNoiseError:
                    g.tau = (0.0, 0.0, 0.0)
            if save:
                with spans.span("post.save"):
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
    """Labels like 'W313' from the topology named in the metadata; falls
    back to 'X{resid}' when no topology is available
    (reference gibbs.py:62-67 uses pickled AtomGroups instead)."""
    top_path = events.meta.top
    if top_path and os.path.exists(top_path):
        try:
            from basicrta_torch.io.topology import convert_aa_code
            from basicrta_torch.io.universe import read_topology
            top = read_topology(top_path)
            out = []
            for resid in resids:
                rn = top.resnames[top.resids == resid]
                try:
                    out.append(f"{convert_aa_code(str(rn[0]))}{resid}"
                               if len(rn) else f"X{resid}")
                except ValueError:
                    out.append(f"X{resid}")
            return out
        except Exception as e:  # noqa: BLE001
            # falling back to X-prefixed labels changes the result
            # directory names (basicrta-{cutoff}/X313 vs W313): say so
            # loudly instead of silently splitting the results tree
            # between reruns
            warnings.warn(
                f"could not read {top_path} for residue labels "
                f"({type(e).__name__}: {e}); falling back to X-prefixed "
                "labels; result directories will be named X<resid>",
                stacklevel=2)
    return [f"X{r}" for r in resids]


class ParallelGibbs:
    """Run Gibbs samplers for every sel1 residue in a contact-event table.

    :param contacts: path to a ``contacts_{cutoff}.npz`` event table, the
        reference package's ``contacts_{cutoff}.pkl``, or a ContactEvents
        instance.
    """

    def __init__(self, contacts: Union[str, ContactEvents],
                 cfg: GibbsConfig = GibbsConfig(), root: str = "."):
        if isinstance(contacts, str):
            if not os.path.exists(contacts):
                raise FileNotFoundError(
                    f"contacts file not found: {contacts}")
            self.cutoff = cutoff_from_filename(contacts)
            if contacts.endswith(".pkl"):
                # the reference's pickled event table works directly
                # (migration path; io/legacy.py restricted unpickler)
                from basicrta_torch.io.legacy import load_reference_contacts
                self.events = load_reference_contacts(contacts)
                if not isinstance(self.events, ContactEvents):
                    raise ValueError(
                        f"{contacts} is a primary contact map; run "
                        "ProcessContacts (or the reference's) to produce "
                        "the residence-event table first")
            else:
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

    def run(self, run_resids=None, mode: str = "batched",
            engine: Optional[str] = None, device=None,
            progress_cb=None, n_devices: Optional[int] = None
            ) -> Dict[str, Gibbs]:
        """Sample all residues (or ``run_resids``) and post-process them.

        ``mode='batched'`` runs every residue as lanes of ``engine`` (the
        fused kernels, their plain versions or the reference collapsed
        sweep; see ``resolve_engine``) on the engine's layout (see
        ``run_residues``), then post-processes
        them in bucketed batches on the same device; ``mode='sequential'``
        runs one residue at a time through :func:`run_residue` (lower peak
        memory; each residue's result is that of ``Gibbs(...).run()``
        alone).

        ``n_devices`` splits the residue x chain lanes, and then the
        post-processing, over a mesh of this process's devices of
        ``device``'s kind (``parallel.mesh.make_mesh``): 0 takes every
        visible card (the CPU once), n the first n (more than are visible
        raises), None runs unsharded. On a multi-host cluster each host
        runs its own residues on its own cards
        (``parallel.distributed.host_residue_partition``). Sequential mode
        runs unsharded."""
        if mode not in ("batched", "sequential"):
            raise ValueError(f"unknown mode {mode!r}; use 'batched' or "
                             "'sequential'")
        engine, device = resolve_engine(engine, device)
        sharding = None
        if n_devices is not None:
            from basicrta_torch.parallel.mesh import lane_sharding, make_mesh
            sharding = lane_sharding(make_mesh(n_lanes=n_devices or None,
                                               device=device))
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
        if mode == "sequential":
            return {lab: run_residue(x, lab, self.cutoff, self.cfg,
                                     self.root, engine, device)
                    for lab, x in times.items()}
        ckpt_dir = os.path.join(self.root, f"basicrta-{self.cutoff}",
                                ".checkpoints")
        samples = run_residues(times, self.cfg, n_chains=self.cfg.n_chains,
                               checkpoint_dir=ckpt_dir, engine=engine,
                               device=device, sharding=sharding,
                               progress_cb=progress_cb)
        out: Dict[str, Gibbs] = {}
        for lab, (W, R) in samples.items():
            g = Gibbs(times[lab], residue=lab, cutoff=self.cutoff,
                      cfg=self.cfg, root=self.root)
            g.mcweights, g.mcrates = W, R
            g.device = device
            out[lab] = g
        finish_batch(out, device=device, sharding=sharding)
        return out


class ProcessProtein:
    """Collect per-residue results and aggregate tau across the protein
    (reference cluster.py:15-192); any post-processing runs on ``device``
    (default the card). ``prot`` names the protein's entry in the TM-helix
    table of the tau-vs-residue figure."""

    def __init__(self, cfg: GibbsConfig = GibbsConfig(),
                 prot: Optional[str] = None, cutoff: float = 7.0,
                 root: str = ".", device=None):
        self.cfg = cfg
        self.prot = prot
        self.cutoff = cutoff
        self.root = root
        self.device = device
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
        """Residue label -> result path (None when missing), by resid; a
        residue without ``gibbs_{niter}.npz`` takes the reference
        package's ``gibbs_{niter}.pkl`` where there is one."""
        self.residues = {}
        for adir in self._result_dirs():
            path = os.path.join(adir, f"gibbs_{self.cfg.niter}.npz")
            if not os.path.exists(path):
                # a reference-package results tree works directly
                # (Gibbs.load dispatches .pkl to io/legacy)
                legacy = os.path.join(adir, f"gibbs_{self.cfg.niter}.pkl")
                path = legacy if os.path.exists(legacy) else None
            self.residues[os.path.basename(adir)] = path
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
        device = self.device if device is None else device
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
                g.device = self.device
                taus.append(list(g.tau) if g.tau is not None
                            else g.estimate_tau())
            except (AllNoiseError, KeyError, ValueError):
                taus.append([0.0, 0.0, 0.0])
        taus = np.asarray(taus, np.float64).reshape(-1, 3)
        return taus[:, 1], ci_bars(taus)

    def _loaded(self):
        """(label, Gibbs) of every residue whose results load."""
        if not self.residues:
            self.collect_results()
        for label, path in self.residues.items():
            if path is None:
                continue
            try:
                g = Gibbs.load(path)
            except (KeyError, ValueError):
                continue
            g.root = self.root
            g.device = self.device
            yield label, g

    def get_taus_all(self):
        """{label: (C, 4) rows [cluster, ci_lo, tau, ci_hi]}: tau of every
        non-noise process of every residue with results."""
        out = {}
        for label, g in self._loaded():
            try:
                out[label] = g.estimate_tau_all()
            except (AllNoiseError, KeyError, ValueError):
                continue
        return out

    def diagnostics_table(self):
        """(labels, (R, 2) rows [max_rhat, min_ess]) over every residue
        with results: split-R-hat / bulk-ESS screening of the whole
        protein."""
        labels, rows = [], []
        for label, g in self._loaded():
            try:
                d = g.diagnostics()
            except (KeyError, ValueError):
                continue
            labels.append(label)
            rows.append([d["max_rhat"], d["min_ess"]])
        return labels, np.asarray(rows, np.float64).reshape(-1, 2)

    def write_diagnostics(self, fname: str = "diagnostics",
                          rhat_warn: float = 1.05,
                          ess_warn: float = 100.0):
        """Write ``{fname}.npz`` (the JAX package's keys) and return
        (path, flagged labels): a residue is flagged when its worst
        split-R-hat exceeds ``rhat_warn`` or its smallest bulk ESS falls
        below ``ess_warn``; NaN diagnostics flag too."""
        labels, rows = self.diagnostics_table()
        flagged = [lab for lab, (r, e) in zip(labels, rows)
                   if not (r <= rhat_warn and e >= ess_warn)]
        path = os.path.join(self.root, f"{fname}.npz")
        np.savez(path, labels=np.asarray(labels),
                 max_rhat=rows[:, 0], min_ess=rows[:, 1],
                 rhat_warn=rhat_warn, ess_warn=ess_warn,
                 flagged=np.asarray(flagged))
        return path, flagged

    def write_data(self, fname: str = "tausout",
                   all_clusters: bool = False) -> str:
        """[resid, tau, CI_lo, CI_hi] table as .npy (cluster.py:122-134);
        with ``all_clusters`` also ``{fname}_all.npy``, one row [resid,
        cluster, ci_lo, tau, ci_hi] per non-noise cluster per residue."""
        taus, bars = self.get_taus()
        resids = np.array([int(label[1:]) for label in self.residues])
        data = np.stack((resids, taus, taus - bars[0], taus + bars[1])).T
        out = os.path.join(self.root, f"{fname}.npy")
        np.save(out, data)
        if all_clusters:
            rows = [[int(label[1:]), *row]
                    for label, table in self.get_taus_all().items()
                    for row in table]
            np.save(os.path.join(self.root, f"{fname}_all.npy"),
                    np.asarray(rows, np.float64).reshape(-1, 5))
        return out

    def plot_taus_all(self, basename: Optional[str] = None):
        """Every residue's non-noise process taus with CIs on a log axis
        (``figs/tau_clusters``; needs matplotlib)."""
        from basicrta_torch.plots import plot_tau_stack
        if basename is None:
            basename = os.path.join(self.root, "figs", "tau_clusters")
        return plot_tau_stack(self.get_taus_all(), basename=basename)

    def plot_protein(self, **kwargs):
        """Tau vs residue (``figs/t_slow``, reference cluster.py:136-155;
        needs matplotlib)."""
        from basicrta_torch.plots import plot_protein
        taus, bars = self.get_taus()
        residues = np.asarray(list(self.residues.keys()))
        exclude = np.unique(np.where(bars < 0)[1])
        taus = np.delete(taus, exclude)
        bars = np.delete(bars, exclude, axis=1)
        residues = np.delete(residues, exclude)
        basename = kwargs.pop("basename",
                              os.path.join(self.root, "figs", "t_slow"))
        return plot_protein(residues, taus, bars, self.prot,
                            basename=basename, **kwargs)

    def b_color_structure(self, structure: str,
                          out: str = "tau_bcolored.pdb") -> str:
        """Write tau into b-factors and tau/CI-width into occupancies of
        the structure's protein atoms (reference cluster.py:157-175)."""
        from basicrta_torch.io.topology import write_pdb
        from basicrta_torch.io.universe import read_topology
        taus, bars = self.get_taus()
        widths = bars[0] + bars[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            errs = np.where(widths > 0, taus / widths, 0.0)
        top = read_topology(structure)
        tempfactors, occupancies = {}, {}
        for label, tau, err in zip(self.residues, taus, errs):
            resid = int(label[1:])
            tempfactors[resid] = round(float(tau), 2)
            occupancies[resid] = round(float(err), 2)
        return write_pdb(os.path.join(self.root, out), top,
                         indices=top.select("protein"),
                         tempfactors=tempfactors, occupancies=occupancies)
