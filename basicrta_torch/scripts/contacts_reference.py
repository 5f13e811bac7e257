"""The plain host version of stage 1: contact rows of single frames.

An implementation of 'any atom of a sel1 residue within the cutoff of any
atom of a sel2 residue, record the pair's minimum distance' that shares
nothing with ``basicrta_torch.contacts.distances``: a
``scipy.spatial.cKDTree`` neighbour search in float64 (periodic through
``boxsize`` on an orthorhombic box), or a brute-force image search under a
triclinic box (small systems only). The smoke run and the tests hold
``MapContacts`` against it; nothing on the main path calls it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# a row whose distance lies this close to the cutoff may be present on one
# side and absent on the other: float32 against float64 rounding
BOUNDARY_TOL = 1e-4


def frame_contacts(positions: np.ndarray, box: Optional[np.ndarray],
                   idx1: np.ndarray, resids1: np.ndarray,
                   idx2: np.ndarray, resids2: np.ndarray,
                   cutoff: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sel1 resid, sel2 resid, min distance) of one frame, for every
    residue pair with an atom pair within ``cutoff``, sorted by (sel1,
    sel2). ``positions`` (A, 3); ``box`` None, (3,) lengths or a (3, 3)
    GROMACS-reduced matrix; ``idx*`` atom indices of the selections and
    ``resids*`` their per-atom residue ids."""
    from scipy.spatial import cKDTree

    p1 = np.asarray(positions, np.float64)[idx1]
    p2 = np.asarray(positions, np.float64)[idx2]
    if box is not None and np.ndim(box) == 2:
        a, b, d = _brute_triclinic(p1, p2, np.asarray(box, np.float64),
                                   cutoff)
    else:
        L = None
        if box is not None:
            L = np.asarray(box, np.float64)
            p1, p2 = (np.where(np.mod(p, L) >= L, 0.0, np.mod(p, L))
                      for p in (p1, p2))
        coo = cKDTree(p1, boxsize=L).sparse_distance_matrix(
            cKDTree(p2, boxsize=L), cutoff, output_type="coo_matrix")
        a, b, d = coo.row, coo.col, coo.data
    r1, r2 = np.asarray(resids1)[a], np.asarray(resids2)[b]
    order = np.lexsort((d, r2, r1))
    r1, r2, d = r1[order], r2[order], d[order]
    first = np.ones(len(d), bool)
    first[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
    return r1[first], r2[first], d[first]


def _brute_triclinic(p1, p2, H, cutoff):
    """Atom pairs within ``cutoff`` under the lattice rows ``H``: every
    image within two cells, in float64."""
    shifts = np.array([[i, j, k] for i in range(-2, 3)
                       for j in range(-2, 3) for k in range(-2, 3)]) @ H
    frac = np.round((p1[:, None, :] - p2[None, :, :]) @ np.linalg.inv(H))
    d = p1[:, None, :] - p2[None, :, :] - frac @ H
    dist = np.sqrt(((d[:, :, None, :] + shifts[None, None]) ** 2).sum(-1)
                   ).min(-1)
    a, b = np.nonzero(dist <= cutoff)
    return a, b, dist[a, b]


def check_frame(rows, reference, cutoff: float, atol: float = 1e-4):
    """Hold one frame's contact rows ``(s1, s2, dist)`` against the
    reference's. Rows present on one side only must lie within
    ``BOUNDARY_TOL`` (+ ``atol`` beyond 1e-4, the wire format's share) of
    the cutoff; shared
    rows must agree within ``atol``. Returns (shared rows, rows on one side
    only, max |distance difference|); raises AssertionError otherwise."""
    edge = BOUNDARY_TOL + max(atol - 1e-4, 0.0)
    got = {(int(a), int(b)): float(d) for a, b, d in zip(*rows)}
    ref = {(int(a), int(b)): float(d) for a, b, d in zip(*reference)}
    shared = got.keys() & ref.keys()
    err = max((abs(got[k] - ref[k]) for k in shared), default=0.0)
    if err > atol:
        raise AssertionError(f"min_dist differs by {err:.3g} A (> {atol:g})")
    lone = [(k, side[k]) for side, other in ((got, ref), (ref, got))
            for k in side.keys() - other.keys()]
    for k, d in lone:
        if abs(d - cutoff) > edge:
            raise AssertionError(
                f"pair {k} at {d:.6f} A is in one result only and not "
                f"within {edge:g} A of the cutoff {cutoff}")
    return len(shared), len(lone), err


def check_records(records, frames, read_frame, idx1, resids1, idx2, resids2,
                  cutoff: float, atol: float = 1e-4):
    """Hold the rows of ``records`` (a ContactRecords) for each frame of
    ``frames`` against :func:`frame_contacts` on ``read_frame(frame)`` ->
    (positions, box). Returns the totals of :func:`check_frame`."""
    shared = lone = 0
    err = 0.0
    for f in frames:
        pos, box = read_frame(int(f))
        ref = frame_contacts(pos, box, idx1, resids1, idx2, resids2, cutoff)
        sel = records.frames == f
        rows = (records.sel1_resids[sel], records.sel2_resids[sel],
                records.min_dist[sel])
        s, n, e = check_frame(rows, ref, cutoff, atol)
        shared, lone, err = shared + s, lone + n, max(err, e)
    return shared, lone, err
