"""Reference-semantics CPU baseline for the contacts stage.

Port of the JAX package's ``scripts/cpu_contacts_baseline.py``. The
reference's contact extraction runs, per frame, MDAnalysis'
``capped_distance`` (a C cell-list neighbour search) and reduces the atom
pairs to a per-(sel1 residue, sel2 residue) minimum distance (reference
contacts.py:115-127). MDAnalysis is not a dependency, so the baseline is
:func:`basicrta_torch.scripts.contacts_reference.frame_contacts`: a
``scipy.spatial.cKDTree`` periodic capped-distance query in float64 and a
vectorised minimum per residue pair, one frame at a time on one CPU core.

It measures frames/s on bench.py's two synthetic workloads
(``basicrta_torch.scripts.workload``):

- membrane: 14,800 atoms (300 residues x 16 against 200 lipids x 50);
- large: 101,400 atoms (400 x 16 against 1,900 x 50).

``--parity`` also runs ``MapContacts`` (on the card unless ``--device
cpu``) and holds its rows against the baseline's frame by frame
(``contacts_reference.check_frame``: shared rows within 1e-4 A, a row on
one side only within ``BOUNDARY_TOL`` of the cutoff).

Usage:
    python -m basicrta_torch.scripts.cpu_contacts_baseline [--reps 3]
        [--parity] [--skip-large] [--device cpu]
"""

import argparse
import time

import numpy as np

from basicrta_torch.scripts.contacts_reference import (check_frame,
                                                       frame_contacts)


def cpu_contacts(batches, resids1, resids2, n_atoms1, cutoff=10.0):
    """Reference-semantics contact rows of a list of FrameBatches: column
    arrays (frames, s1, s2, dist, times) in the schema of ContactRecords,
    sorted by (frame, s1, s2)."""
    idx1 = np.arange(n_atoms1)
    idx2 = np.arange(n_atoms1, n_atoms1 + len(resids2))
    out = {k: [] for k in ("frames", "s1", "s2", "dist", "times")}
    for b in batches:
        for k in range(len(b.frame_ids)):
            box = None if b.box is None else b.box[k]
            s1, s2, d = frame_contacts(b.positions[k], box, idx1, resids1,
                                       idx2, resids2, cutoff)
            out["frames"].append(np.full(len(d), b.frame_ids[k], np.int64))
            out["s1"].append(s1.astype(np.int32))
            out["s2"].append(s2.astype(np.int32))
            out["dist"].append(d.astype(np.float32))
            out["times"].append(np.full(len(d), b.times[k], np.float64))
    return {k: (np.concatenate(v) if v else np.zeros(0))
            for k, v in out.items()}


def check_parity(rows, rec, cutoff=10.0):
    """The baseline's rows against a ContactRecords, frame by frame.
    Returns (shared rows, rows on one side only, max |distance gap|)."""
    shared = lone = 0
    err = 0.0
    for f in np.unique(np.concatenate([rows["frames"], rec.frames])):
        a, b = rows["frames"] == f, rec.frames == f
        s, n, e = check_frame(
            (rec.sel1_resids[b], rec.sel2_resids[b], rec.min_dist[b]),
            (rows["s1"][a], rows["s2"][a], rows["dist"][a]), cutoff)
        shared, lone, err = shared + s, lone + n, max(err, e)
    return shared, lone, err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--parity", action="store_true",
                    help="also run MapContacts and check row parity")
    ap.add_argument("--skip-large", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where --parity's MapContacts runs: the card (the "
                         "default; raises without one) or the CPU")
    args = ap.parse_args(argv)

    if args.parity:
        from basicrta_torch.contacts.mapper import _resolve_device
        _resolve_device(args.device)      # the card unless asked
    from basicrta_torch.scripts.workload import (make_membrane_frames,
                                                 make_membrane_frames_large)
    workloads = {"membrane": make_membrane_frames()}
    if not args.skip_large:
        workloads["large"] = make_membrane_frames_large()

    results = {}
    for name, (batches, resids1, resids2, A1) in workloads.items():
        n_frames = sum(len(b.frame_ids) for b in batches)
        n_atoms = batches[0].positions.shape[1]
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            rows = cpu_contacts(batches, resids1, resids2, A1)
            best = min(best, time.perf_counter() - t0)
        print(f"{name}: {n_atoms:,} atoms, {n_frames} frames, "
              f"{len(rows['frames']):,} rows -> "
              f"{n_frames / best:.2f} frames/s "
              f"(best of {args.reps}, 1 CPU core)", flush=True)
        results[name] = (n_frames / best, rows)
        if args.parity:
            from basicrta_torch.config import ContactConfig
            from basicrta_torch.contacts.mapper import MapContacts
            from basicrta_torch.contacts.records import ContactMeta
            A2 = len(resids2)
            mc = MapContacts(indices1=np.arange(A1), resids1=resids1,
                             indices2=np.arange(A1, A1 + A2),
                             resids2=resids2, cfg=ContactConfig(),
                             meta=ContactMeta(ts=0.1), device=args.device)
            s, n, e = check_parity(rows, mc.run(batches))
            print(f"  parity OK: {s} rows shared, {n} within the cutoff's "
                  f"rounding on one side, max |d_cpu - d_dev| = {e:.2e} A",
                  flush=True)
    return results


if __name__ == "__main__":
    main()
