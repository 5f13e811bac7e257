"""Kinetic mapping of posterior component probabilities onto trajectories.

Port of ``basicrta_tpu.kinetics.mapper`` (reference kinetics.py:9-204).
``MapKinetics`` expands each residence event of one residue into its
trajectory frame range, attaches the event's posterior
component-membership probabilities, writes reduced per-component
trajectories (sel1 + the contacting sel2 residue), and renders
posterior-weighted 3D densities. The frame table, the row orders and the
written trajectories are host numpy and equal the JAX package's; only the
density scatter-add runs on ``device`` (default the card).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from basicrta_torch.contacts.records import ContactEvents
from basicrta_torch.io.native import TRAJ_WRITE_FORMATS, trajectory_writer
from basicrta_torch.io.topology import Topology, write_gro
from basicrta_torch.io.universe import Universe
from basicrta_torch.kinetics.density import (GridAccumulator, WDensity,
                                             resolve_device)
from basicrta_torch.ops.surv import start_stop_frames


def _resid_of(residue) -> int:
    """Residue id from a 'W313'-style label, a plain '313' string, or an
    int (Gibbs permits all three through save/load round-trips)."""
    m = re.search(r"-?\d+", str(residue))
    if m is None:
        raise ValueError(f"cannot parse a residue id from {residue!r}")
    return int(m.group())


class MapKinetics:
    """Map per-event posterior probabilities back onto trajectory frames.

    :param gibbs: processed Gibbs instance of one residue.
    :param contacts: ContactEvents (or path) whose metadata names the
        topology/trajectory (reference kinetics.py:22-44).
    :param traj_format: extension of the reduced trajectories written by
        :meth:`create_traj`/:meth:`write_component_trajs`: ``xtc``
        (default), ``trr``, ``dcd`` or ``nc``.
    :param device: where :meth:`weighted_densities` accumulates: the card
        (default; raises without one) or the CPU.
    """

    # above this many rows the frame table is written as an on-disk
    # .npy memmap instead of RAM: the expanded table can reach GBs
    # (reference kinetics.py:46-77 memmaps unconditionally)
    MEMMAP_ROWS = 2_000_000

    def __init__(self, gibbs, contacts, root: Optional[str] = None,
                 traj_format: str = "xtc", device=None):
        if traj_format not in TRAJ_WRITE_FORMATS:
            raise ValueError(f"traj_format {traj_format!r} not one of "
                             f"{TRAJ_WRITE_FORMATS}")
        self.traj_format = traj_format
        self.device = resolve_device(device)
        self.gibbs = gibbs
        if isinstance(contacts, str) and contacts.endswith(".pkl"):
            raise NotImplementedError(
                "reference pickles (.pkl) load through io/legacy.py, which "
                "the port has not taken yet (ROADMAP queue 1 item 8); "
                "convert the event table with basicrta_tpu first")
        if isinstance(contacts, str):
            contacts = ContactEvents.load(contacts)
        if not isinstance(contacts, ContactEvents):
            raise ValueError(
                "MapKinetics needs the residence-EVENT table "
                "(contacts_{cutoff}); got a primary contact map; run "
                "ProcessContacts (or the reference's) first")
        self.events = contacts
        self.meta = contacts.meta
        self.root = root or gibbs.root
        self.cutoff = gibbs.cutoff
        self.savedir = gibbs.savedir
        self._frame_table = None

    # ------------------------------------------------------------------ #
    def frame_table(self, memmap: Optional[bool] = None,
                    event_chunk: int = 65536) -> np.ndarray:
        """(T, 2 + ncomp) rows [frame, sel2_resid, p_0..p_k]: every frame of
        every residence event of this residue (reference kinetics.py:46-77,
        '_create_data' memmap).

        The table is filled in bounded event chunks; with ``memmap`` (auto
        when the expansion exceeds MEMMAP_ROWS rows) it lives in an on-disk
        ``den_write_data.npy`` memmap, so peak RAM stays at the chunk size
        regardless of trajectory length.
        """
        if self._frame_table is not None:
            return self._frame_table
        resid = _resid_of(self.gibbs.residue)
        sel = self.events.sel1_resids == resid
        starts = self.events.start_times[sel]
        durs = self.events.durations[sel]
        lips = self.events.sel2_resids[sel]
        ts = self.meta.ts or self.gibbs.ts
        pind = self.gibbs.pindicator_per_event()   # aligned with durations
        if len(pind) != len(durs):
            raise ValueError(
                f"the Gibbs run has {len(pind)} events for residue "
                f"{self.gibbs.residue} but this contacts table has "
                f"{len(durs)}; the table was built at a different "
                "cutoff/selection than the one sampled; pass the "
                "contacts file the Gibbs run came from")
        first, last = start_stop_frames(starts, durs, ts)
        nper = (last - first + 1).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(nper)])
        total = int(offsets[-1])
        ncomp = pind.shape[1]
        if memmap is None:
            memmap = total > self.MEMMAP_ROWS
        if memmap:
            from numpy.lib.format import open_memmap
            os.makedirs(self.savedir, exist_ok=True)
            table = open_memmap(
                os.path.join(self.savedir, "den_write_data.npy"),
                mode="w+", dtype=np.float64, shape=(total, 2 + ncomp))
        else:
            table = np.empty((total, 2 + ncomp), np.float64)
        for lo in range(0, len(nper), event_chunk):
            hi = min(lo + event_chunk, len(nper))
            r0, r1 = int(offsets[lo]), int(offsets[hi])
            np_chunk = nper[lo:hi]
            table[r0:r1, 0] = np.concatenate(
                [np.arange(b, e + 1) for b, e in
                 zip(first[lo:hi], last[lo:hi])])
            table[r0:r1, 1] = np.repeat(lips[lo:hi], np_chunk)
            table[r0:r1, 2:] = np.repeat(pind[lo:hi], np_chunk, axis=0)
        self._frame_table = table
        return table

    # ------------------------------------------------------------------ #
    def _open_universe(self) -> Universe:
        if not (self.meta.top and self.meta.traj):
            raise ValueError("contact metadata lacks top/traj paths")
        return Universe(self.meta.top, self.meta.traj)

    def create_traj(self, top_n: Optional[int] = None) -> list:
        """Write reduced trajectories of sel1 + the contacting sel2 residue.

        ``top_n=None``: one trajectory over every contact frame (a source
        frame may repeat when multiple sel2 residues bind at once);
        otherwise one trajectory per component over its ``top_n`` most
        probable frames (reference kinetics.py:79-125).
        """
        u = self._open_universe()
        idx1 = u.select_atoms(self.meta.sel1 or "protein")
        idx2 = u.select_atoms(self.meta.sel2 or "not protein")
        resids2 = u.topology.resids[idx2]
        table = self.frame_table()
        ncomp = table.shape[1] - 2

        # reduced topology: sel1 + one sel2 residue (reference reduced.gro)
        first_lip = resids2[0]
        lip_idx0 = idx2[resids2 == first_lip]
        red_idx = np.concatenate([idx1, lip_idx0])
        os.makedirs(self.savedir, exist_ok=True)
        topname = os.path.join(self.savedir, "reduced.gro")
        write_gro(topname, _subset_topology(u.topology, red_idx))

        written = []
        if top_n is None:
            out = os.path.join(self.savedir, f"traj_all.{self.traj_format}")
            if os.path.exists(out):
                raise FileExistsError(f"{out} exists, remove then rerun")
            self._write_reduced(u, idx1, idx2, table[:, 0].astype(int),
                                table[:, 1].astype(int), out)
            written.append(out)
        else:
            for k in range(ncomp):
                # numpy's argsort, as the JAX package: its tie order
                # decides which rows make the top N
                order = np.argsort(table[:, 2 + k])[::-1][:top_n]
                out = os.path.join(
                    self.savedir,
                    f"traj_comp{k}_top{top_n}.{self.traj_format}")
                self._write_reduced(u, idx1, idx2,
                                    table[order, 0].astype(int),
                                    table[order, 1].astype(int), out)
                written.append(out)
        return written

    def write_component_trajs(self, step: int = 1) -> list:
        """One reduced trajectory per component over the frames of events
        *assigned* to it (argmax of the membership probabilities), strided
        by ``step``: the reference's write_trajs/get_write_frames surface
        (util.py:523-562, 'comp{k}_traj.xtc')."""
        u = self._open_universe()
        idx1 = u.select_atoms(self.meta.sel1 or "protein")
        idx2 = u.select_atoms(self.meta.sel2 or "not protein")
        table = self.frame_table()
        ncomp = table.shape[1] - 2
        assigned = np.argmax(table[:, 2:], axis=1)
        os.makedirs(self.savedir, exist_ok=True)
        written = []
        for k in range(ncomp):
            rows = np.where(assigned == k)[0][::step]
            if len(rows) == 0:
                continue
            out = os.path.join(self.savedir,
                               f"comp{k}_traj.{self.traj_format}")
            self._write_reduced(u, idx1, idx2,
                                table[rows, 0].astype(int),
                                table[rows, 1].astype(int), out)
            written.append(out)
        return written

    @staticmethod
    def _residue_atoms(idx2, resids2, lipids):
        """(rows, amax) atom indices of each row's sel2 residue (padded
        with its first atom) and (rows,) live-atom counts."""
        lips = np.unique(lipids)
        per = [idx2[resids2 == lip] for lip in lips]
        amax = max(len(p) for p in per)
        table = np.stack([np.pad(p, (0, amax - len(p)), mode="edge")
                          for p in per])
        which = np.searchsorted(lips, lipids)
        return table[which], np.asarray([len(p) for p in per])[which]

    def _write_reduced(self, u: Universe, idx1, idx2, frames, lipids, out,
                       chunk: int = 256):
        resids2 = u.topology.resids[idx2]
        # XTC (and the reduced.gro built from the first sel2 residue)
        # needs a fixed atom count per frame; heterogeneous sel2 types
        # cannot share one reduced trajectory
        counts = {int(lip): int((resids2 == lip).sum())
                  for lip in np.unique(lipids)}
        if len(set(counts.values())) > 1:
            raise ValueError(
                "contacting sel2 residues have differing atom counts "
                f"({sorted(set(counts.values()))}); a reduced trajectory "
                "needs one residue type; narrow sel2 (e.g. 'resname "
                "POPC') and rerun contacts")
        ts = self.meta.ts or self.gibbs.ts
        box = (np.tile(u.topology.box, (1, 1))
               if u.topology.box is not None else np.full((1, 3), 1000.0))
        # dt_ns seeds the DCD header interval: the frames written here are
        # non-contiguous (event/top-N selections), so inferring it from
        # their gaps would fabricate a wrong time axis
        with trajectory_writer(out, dt_ns=ts) as writer:
            for lo in range(0, len(frames), chunk):
                fr = frames[lo:lo + chunk]
                lip_atoms, _ = self._residue_atoms(idx2, resids2,
                                                   lipids[lo:lo + chunk])
                atoms = np.concatenate(
                    [np.broadcast_to(idx1, (len(fr), len(idx1))),
                     lip_atoms], axis=1)
                pos = u.frame_positions(fr)
                sel_pos = np.take_along_axis(pos, atoms[..., None], axis=1)
                # monotonic step numbers across chunks (tools key on them)
                writer.write(sel_pos, fr * ts,
                             np.repeat(box, len(fr), axis=0),
                             steps=np.arange(lo, lo + len(fr)))

    # ------------------------------------------------------------------ #
    def weighted_densities(self, step: int = 1, top_n: Optional[int] = None,
                           filterP: float = 0.0, frame_chunk: int = 512,
                           gridcenter=None, xdim: float = 40.0,
                           ydim: float = 40.0, zdim: float = 40.0,
                           delta: float = 1.0):
        """Posterior-weighted sel2 densities around the residue
        (reference kinetics.py:127-204), accumulated on ``self.device``.

        ``top_n=None``: one density per component over all contact frames
        (pwdensity variant); otherwise per-component densities over the
        top-N most probable frames (wdensity variant). Returns the list of
        written .dx paths.

        The grid defaults to a 40 A cube at 1 A resolution centered on the
        residue (reference kinetics.py:165-168); ``gridcenter``/``xdim``/
        ``ydim``/``zdim``/``delta`` override it (the reference's
        user-grid surface, wdensity.py ``_set_user_grid``).
        """
        u = self._open_universe()
        idx1 = u.select_atoms(self.meta.sel1 or "protein")
        idx2 = u.select_atoms(self.meta.sel2 or "not protein")
        resids2 = u.topology.resids[idx2]
        resid = _resid_of(self.gibbs.residue)
        table = self.frame_table()
        ncomp = table.shape[1] - 2

        if gridcenter is None:
            res_idx = u.topology.select(f"resid {resid}")
            res_idx = np.intersect1d(res_idx, idx1)
            center = u.frame_positions([0])[0][res_idx].mean(axis=0)
        else:
            center = np.asarray(gridcenter, np.float64)
        grid_kw = dict(xdim=xdim, ydim=ydim, zdim=zdim, delta=delta,
                       device=self.device)

        def stream(rows, acc, weights=None):
            """Accumulate table rows chunkwise: the table can be an
            on-disk memmap of GB scale, so neither the positions nor the
            probability columns ever materialise whole (weights=None
            reads all P columns per chunk; else a per-row vector)."""
            for lo in range(0, len(rows), frame_chunk):
                rr = rows[lo:lo + frame_chunk]
                w = np.asarray(table[rr, 2:] if weights is None
                               else weights[lo:lo + frame_chunk],
                               np.float32)
                if filterP > 0:
                    w = np.where(w < filterP, 0.0, w)
                fr = table[rr, 0].astype(int)
                lp = table[rr, 1].astype(int)
                pos, mask = self._contact_positions(u, idx2, resids2,
                                                    fr, lp)
                acc.add(pos, w, mask, frame_chunk)

        os.makedirs(self.savedir, exist_ok=True)
        suffix = f"_step{step}" if step > 1 else ""
        outnames = []
        if top_n is None:
            rows = np.arange(0, len(table), step)
            acc = GridAccumulator(ncomp, center, **grid_kw)
            stream(rows, acc)
            d = WDensity.from_accumulator(acc)
            for k, den in enumerate(d.densities):
                out = os.path.join(self.savedir,
                                   f"wcomp{k}_all{suffix}.dx")
                outnames.append(den.export(out))
        else:
            for k in range(ncomp):
                wk = np.asarray(table[:, 2 + k])
                if filterP > 0:
                    wk = np.where(wk < filterP, 0.0, wk)
                # numpy's argsort: its tie order decides the kept rows
                order = np.argsort(wk)[::-1]
                keep = order[wk[order] > 0][:top_n:step]
                if len(keep) == 0:
                    continue
                acc = GridAccumulator(1, center, **grid_kw)
                stream(keep, acc, wk[keep])
                d = WDensity.from_accumulator(acc)
                out = os.path.join(self.savedir,
                                   f"wcomp{k}_top{top_n}{suffix}.dx")
                outnames.append(d.density.export(out))
        return outnames

    def _contact_positions(self, u, idx2, resids2, frames, lipids):
        """Positions of the contacting sel2 residue at each table row,
        padded with zeros to the widest residue, and the (rows, A)
        live-atom mask (sel2 may mix residue types with differing atom
        counts)."""
        atoms, n_live = self._residue_atoms(idx2, resids2, lipids)
        mask = (np.arange(atoms.shape[1])[None] < n_live[:, None])
        pos = u.frame_positions(frames)
        out = np.take_along_axis(pos, atoms[..., None], axis=1)
        out = np.where(mask[..., None], out, 0.0).astype(np.float32)
        return out, mask.astype(np.float32)


def _subset_topology(top, indices):
    return Topology(top.names[indices], top.resids[indices],
                    top.resnames[indices],
                    None if top.positions is None else
                    top.positions[indices], top.box)
