"""Residence-event construction from contact records.

Reproduces the observable semantics of the reference's ``_lipswap``
(contacts.py:197-231): per (sel1 residue, sel2 residue) pair, contiguous
contact frames merge into one event with ``duration = n_frames * ts`` and
``start_time`` = first frame's time; isolated single frames become events of
duration ``ts``. The reference loops per lipid in a process pool with
sentinel-padding/diff logic; here one vectorized sort + run-length pass
handles the entire table at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from basicrta_torch.contacts.records import ContactRecords, ContactEvents
from basicrta_torch.ops.surv import decimals_of


def merge_events(records: ContactRecords, cutoff: float) -> ContactEvents:
    """Filter the primary map to ``cutoff`` and merge frames into events.

    A run breaks when the residue pair changes or the frame gap exceeds one
    timestep (the reference's ``diff > ts`` test on rounded times,
    contacts.py:215-219; we compare the records' GLOBAL frame indices,
    which is exact on the timestep grid and immune to time axes that
    repeat across chained trajectory segments).
    """
    rec = records.filter_cutoff(cutoff)
    ts = rec.meta.ts
    if ts is None:
        raise ValueError("ContactRecords.meta.ts is required to merge events")
    if len(rec) == 0:
        return ContactEvents(
            np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float64), np.zeros(0, np.float64), rec.meta)

    dec = decimals_of(ts)
    tidx = np.asarray(rec.frames, np.int64)
    order = np.lexsort((tidx, rec.sel2_resids, rec.sel1_resids))
    s1 = rec.sel1_resids[order]
    s2 = rec.sel2_resids[order]
    t = tidx[order]
    times = np.round(rec.times[order], dec)

    new_run = np.ones(len(t), dtype=bool)
    new_run[1:] = ((s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
                   | (t[1:] - t[:-1] > 1))
    starts = np.flatnonzero(new_run)
    lengths = np.diff(np.append(starts, len(t)))

    return ContactEvents(
        sel1_resids=s1[starts].astype(np.int32),
        sel2_resids=s2[starts].astype(np.int32),
        start_times=times[starts],
        durations=np.round(lengths * ts, dec),
        meta=dataclasses.replace(rec.meta, cutoff=cutoff))
