"""Typed, struct-of-arrays contact data model with NPZ persistence.

The reference stores contact data as pickled ``np.memmap`` row matrices whose
*dtype metadata* smuggles the topology/trajectory paths, live AtomGroup
objects, timestep, and cutoff (reference contacts.py:79-94). Pickled
AtomGroups are fragile and unsafe; here the same information is explicit:
column arrays plus a JSON metadata dict, persisted as NPZ.

``ContactRecords`` is the primary contact map (one row per frame x residue
pair within the map cutoff; schema of contacts.pkl rows
[frame, sel1_resid, sel2_resid, min_dist, time_ns], contacts.py:125-127).
``ContactEvents`` is the residence-event table (schema of
contacts_{cutoff}.pkl rows [sel1_resid, sel2_resid, start_time, duration],
contacts.py:227-229).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class ContactMeta:
    """Explicit replacement for the reference's dtype-metadata payload
    (contacts.py:80-84)."""
    top: Optional[str] = None        # topology path
    traj: Optional[object] = None    # trajectory path or segment list
    sel1: Optional[str] = None       # selection string for group 1
    sel2: Optional[str] = None       # selection string for group 2
    ts: Optional[float] = None       # frame interval [ns]
    cutoff: Optional[float] = None   # cutoff used [A]

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ContactMeta":
        return cls(**d)


@dataclasses.dataclass
class ContactRecords:
    """Primary contact map: one row per (frame, sel1 residue, sel2 residue)
    pair with any-atom distance below the map cutoff."""
    frames: np.ndarray       # (N,) int64 frame indices
    sel1_resids: np.ndarray  # (N,) int32
    sel2_resids: np.ndarray  # (N,) int32
    min_dist: np.ndarray     # (N,) float32 minimum atomic distance [A]
    times: np.ndarray        # (N,) float64 frame time [ns]
    meta: ContactMeta

    def __len__(self) -> int:
        return len(self.frames)

    def filter_cutoff(self, cutoff: float) -> "ContactRecords":
        """Impose a tighter analysis cutoff on the primary map
        (reference contacts.py:163)."""
        keep = self.min_dist <= cutoff
        meta = dataclasses.replace(self.meta, cutoff=cutoff)
        return ContactRecords(self.frames[keep], self.sel1_resids[keep],
                              self.sel2_resids[keep], self.min_dist[keep],
                              self.times[keep], meta)

    def save(self, path: str) -> str:
        np.savez_compressed(
            path, _meta=json.dumps(self.meta.to_dict()), frames=self.frames,
            sel1_resids=self.sel1_resids, sel2_resids=self.sel2_resids,
            min_dist=self.min_dist, times=self.times)
        return path

    @classmethod
    def load(cls, path: str) -> "ContactRecords":
        with np.load(path, allow_pickle=False) as z:
            return cls(z["frames"], z["sel1_resids"], z["sel2_resids"],
                       z["min_dist"], z["times"],
                       ContactMeta.from_dict(json.loads(str(z["_meta"]))))


@dataclasses.dataclass
class ContactEvents:
    """Residence events: contiguous contact intervals per residue pair."""
    sel1_resids: np.ndarray  # (M,) int32
    sel2_resids: np.ndarray  # (M,) int32
    start_times: np.ndarray  # (M,) float64 [ns]
    durations: np.ndarray    # (M,) float64 [ns]
    meta: ContactMeta

    def __len__(self) -> int:
        return len(self.start_times)

    def times_for_residue(self, resid: int) -> np.ndarray:
        """All residence durations of one sel1 residue — the Gibbs sampler
        input (reference gibbs.py:68-69)."""
        return self.durations[self.sel1_resids == resid]

    def times_per_residue(self) -> Dict[int, np.ndarray]:
        return self.split_by_residue()

    def split_by_residue(self, resids=None) -> Dict[int, np.ndarray]:
        """Every sel1 residue's durations (or those of ``resids``) in one
        pass: a stable sort by residue and one split, so each residue's
        times keep their table order, as :meth:`times_for_residue` gives
        them; a residue with no events gets an empty array."""
        order = np.argsort(self.sel1_resids, kind="stable")
        keys = self.sel1_resids[order]
        uniq, starts = np.unique(keys, return_index=True)
        parts = np.split(self.durations[order], starts[1:])
        out = {int(r): p for r, p in zip(uniq, parts)}
        if resids is None:
            return out
        empty = self.durations[:0]
        return {int(r): out.get(int(r), empty) for r in resids}

    def save(self, path: str) -> str:
        np.savez_compressed(
            path, _meta=json.dumps(self.meta.to_dict()),
            sel1_resids=self.sel1_resids, sel2_resids=self.sel2_resids,
            start_times=self.start_times, durations=self.durations)
        return path

    @classmethod
    def load(cls, path: str) -> "ContactEvents":
        with np.load(path, allow_pickle=False) as z:
            return cls(z["sel1_resids"], z["sel2_resids"], z["start_times"],
                       z["durations"],
                       ContactMeta.from_dict(json.loads(str(z["_meta"]))))

    def as_rows(self) -> np.ndarray:
        """(M, 4) row matrix in the reference's column order
        (contacts.py:227-229)."""
        return np.stack([self.sel1_resids.astype(np.float64),
                         self.sel2_resids.astype(np.float64),
                         self.start_times, self.durations], axis=1)
