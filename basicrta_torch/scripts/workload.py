"""The synthetic workloads of the benchmarks.

The port's copies of ``bench.py``'s generators; the same seed gives the
same data as ``bench.py``.

- ``make_workload``: the all-residue protein. One flagship residue at the
  bundled W313 dataset's size (446,605 events) and residues whose event
  counts are log-uniform in 10^2..10^5.3, each a hyperexponential mixture
  with the W313 posterior's shape, discretised to 0.1 ns.
- ``make_membrane_frames`` / ``make_membrane_frames_large``: contact
  workloads at membrane (14,800 atoms, the dense kernel) and bilayer scale
  (101,400 atoms, the pruned kernel), and ``write_membrane_files``, which
  writes one as a ``.gro`` topology and an ``.xtc`` trajectory through the
  port's own codec.
"""

from __future__ import annotations

import os

import numpy as np

from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp

W313_EVENTS = 446_605
N_RESIDUES = 300


def discretize(times, ts=0.1):
    """Round to multiples of the timestep ``ts``, at least one step."""
    return discretize_times(times, ts)


def make_workload(n_residues=N_RESIDUES, seed=0, flagship=W313_EVENTS):
    """{residue index: residence times}: the flagship residue (``flagship``
    events) and ``n_residues - 1`` log-uniform 10^2..10^5.3-event ones."""
    rng = np.random.default_rng(seed)
    w = np.array([0.87, 0.09, 0.03, 0.009, 0.001])
    r = np.array([4.7, 1.3, 0.33, 0.06, 0.009])
    sizes = np.concatenate([
        [flagship],
        (10 ** rng.uniform(2.0, 5.3, n_residues - 1)).astype(int)])
    residues = {}
    for i, n in enumerate(sizes):
        scale = rng.uniform(0.7, 1.5)
        residues[i] = discretize(simulate_hyperexp(int(n), w, r * scale,
                                                   rng))
    return residues


def _membrane(n_frames, batch, seed, R1, P1, R2, P2, box_l, first_resid2):
    """Compact residue clusters scattered in a box, each drifting by 0.4 A
    a frame around its centre: ``R1`` protein residues of ``P1`` atoms
    (sigma 2.0 A) against ``R2`` lipids of ``P2`` atoms (sigma 2.5 A).
    Returns (FrameBatch list, resids1, resids2, sel1 atom count)."""
    from basicrta_torch.contacts.records import FrameBatch

    rng = np.random.default_rng(seed)
    box_l = np.asarray(box_l, np.float32)
    c1 = rng.uniform(0, 1, (R1, 3)) * box_l
    c2 = rng.uniform(0, 1, (R2, 3)) * box_l
    resids1 = np.repeat(np.arange(R1), P1)
    resids2 = np.repeat(np.arange(R2) + first_resid2, P2)
    batches = []
    for lo in range(0, n_frames, batch):
        F = min(batch, n_frames - lo)
        drift1 = c1[None] + rng.normal(0, 0.4, (F, R1, 3))
        drift2 = c2[None] + rng.normal(0, 0.4, (F, R2, 3))
        p1 = (drift1[:, :, None] + rng.normal(0, 2.0, (F, R1, P1, 3)))
        p2 = (drift2[:, :, None] + rng.normal(0, 2.5, (F, R2, P2, 3)))
        pos = np.concatenate([p1.reshape(F, -1, 3), p2.reshape(F, -1, 3)],
                             axis=1).astype(np.float32)
        batches.append(FrameBatch(
            np.arange(lo, lo + F), np.arange(lo, lo + F) * 0.1, pos,
            box=np.tile(box_l, (F, 1))))
    return batches, resids1, resids2, R1 * P1


def make_membrane_frames(n_frames=96, batch=16, seed=7):
    """Membrane-scale contact workload: 300 protein residues x 16 atoms
    against 200 lipids x 50 atoms (14,800 atoms in the two selections, 48M
    atom pairs a frame) in a 120 x 120 x 90 A box; the dense kernel."""
    return _membrane(n_frames, batch, seed, 300, 16, 200, 50,
                     (120.0, 120.0, 90.0), 1000)


def make_membrane_frames_large(n_frames=48, batch=16, seed=11):
    """Bilayer-scale contact workload: 400 protein residues x 16 atoms
    against 1,900 lipids x 50 atoms, 101,400 atoms in the two selections,
    in a 240 x 240 x 155 A box at the membrane workload's density. 608M
    atom pairs a frame put it past ``prefilter_auto_pairs``: the
    bounding-sphere pruned kernel."""
    return _membrane(n_frames, batch, seed, 400, 16, 1900, 50,
                     (240.0, 240.0, 155.0), 10000)


_AA = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
       "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")


def write_membrane_files(dirpath, batches, resids1, resids2, stem="membrane"):
    """A membrane workload as ``<stem>.gro`` + ``<stem>.xtc`` in
    ``dirpath``: protein residues numbered from 1 with amino-acid names in
    turn (selection ``protein``), the lipids as ``CHOL`` under their own
    resids (selection ``resname CHOL``). XTC keeps a 0.01 A grid, so the
    frames read back are the written ones to that precision. Returns
    (gro path, xtc path)."""
    from basicrta_torch.io.native import XTCWriter
    from basicrta_torch.io.topology import Topology, write_gro

    r1 = np.asarray(resids1) + 1
    resids = np.concatenate([r1, np.asarray(resids2)]).astype(np.int32)
    resnames = np.concatenate([np.asarray(_AA)[(r1 - 1) % len(_AA)],
                               np.full(len(resids2), "CHOL")])
    names = np.concatenate([np.full(len(r1), "CA"),
                            np.full(len(resids2), "C1")])
    first = batches[0]
    top = Topology(names, resids, resnames, first.positions[0],
                   np.asarray(first.box[0], np.float32))
    gro = write_gro(os.path.join(dirpath, f"{stem}.gro"), top)
    xtc = os.path.join(dirpath, f"{stem}.xtc")
    with XTCWriter(xtc) as w:
        for b in batches:
            w.write(b.positions, b.times, b.box,
                    steps=np.asarray(b.frame_ids, np.int32))
    return gro, xtc
