"""Universe: topology + trajectory, streaming frame batches to the pipeline.

The minimal analogue of the MDAnalysis Universe the reference builds at the
top of each stage (reference contacts.py:246-249, kinetics.py:103): parse a
topology (GRO/PDB/PSF/PRMTOP), attach a trajectory (XTC/TRR/DCD/NetCDF/
mdcrd), select atom groups, and iterate device-sized frame batches.
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, Optional, Sequence

import numpy as np

from basicrta_torch.contacts.records import FrameBatch
from basicrta_torch.io.amber import (InpcrdReader, MDCRDReader, NCDFReader,
                                   read_prmtop)
from basicrta_torch.io.native import DCDReader, TRRReader, XTCReader
from basicrta_torch.io.topology import (PDBModelReader, Topology,
                                      box_from_cosines, read_gro,
                                      read_pdb, read_psf)


def _tpr_digest(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _dump_tpr(path: str) -> str:
    """Render a binary ``.tpr`` to its ``gmx dump`` text form, cached as
    ``{path}.dump`` next to the input. The reference accepts a raw
    ``.tpr`` because MDAnalysis parses the binary (reference
    contacts.py:246-249); here the binary's versioned layout is delegated
    to the user's own GROMACS install, which by construction matches the
    file it wrote.

    The cache is keyed on the ``.tpr``'s content: ``{path}.dump.sha256``
    holds the SHA-256 of the bytes the dump was rendered from, and the
    dump is served only while it matches (an mtime test misses a rewrite
    within one clock tick of the cache, and serves the old topology).
    The old sidecar is removed before the dump is moved into place and
    the new one written after, so a run killed in between leaves no
    sidecar vouching for a dump it was not rendered from. The ``.dump``
    text is exactly what ``gmx dump`` printed. A directory the cache
    cannot be written to raises the manual recipe as a ``ValueError``."""
    import subprocess
    import shutil as _shutil

    cache = path + ".dump"
    sidecar = cache + ".sha256"
    recipe = (f"    gmx dump -s {path} > {path}.dump\n"
              f"and pass the .dump file as the topology (io/gmxdump.py)")
    digest = _tpr_digest(path)
    try:
        with open(sidecar) as f:
            if f.read().strip() == digest and os.path.exists(cache):
                return cache
    except OSError:
        pass
    gmx = os.environ.get("BASICRTA_GMX") or _shutil.which("gmx")
    if gmx is None:
        raise ValueError(
            f"binary TPR files need GROMACS to render; no `gmx` on PATH. "
            f"Either install GROMACS (the CLI then converts "
            f"automatically) or convert manually with\n{recipe}")
    tmp = cache + ".tmp"

    def unwritable(e):
        for p in (tmp, sidecar + ".tmp"):
            try:
                os.remove(p)
            except OSError:
                pass
        return ValueError(
            f"cannot write the rendered topology next to {path} "
            f"(directory {os.path.dirname(os.path.abspath(path))}: {e}); "
            f"convert manually with\n{recipe}")

    try:
        out = open(tmp, "w")
    except OSError as e:
        raise unwritable(e) from e
    with out:
        proc = subprocess.run([gmx, "dump", "-s", path], stdout=out,
                              stderr=subprocess.PIPE, text=True)
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise ValueError(
            f"`{gmx} dump -s {path}` failed "
            f"(exit {proc.returncode}):\n{proc.stderr[-2000:]}")
    try:
        # the old sidecar goes first: it must never vouch for the new dump
        if os.path.exists(sidecar):
            os.remove(sidecar)
        os.replace(tmp, cache)   # atomic: readers never see a partial dump
        with open(sidecar + ".tmp", "w") as f:
            f.write(digest + "\n")
        os.replace(sidecar + ".tmp", sidecar)
    except OSError as e:
        raise unwritable(e) from e
    return cache


def read_topology(path: str) -> Topology:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gro":
        return read_gro(path)
    if ext == ".pdb":
        return read_pdb(path)
    if ext == ".psf":
        return read_psf(path)
    if ext in (".prmtop", ".parm7"):
        return read_prmtop(path)
    from basicrta_torch.io.gmxdump import looks_like_tpr_dump, read_tpr_dump
    if ext == ".tpr":
        # TPR is a versioned binary whose layout changes across GROMACS
        # releases; read its stable text rendering, produced on the fly
        # by the user's own gmx when available (cached as {path}.dump)
        return read_tpr_dump(_dump_tpr(path))
    if ext in (".dump", ".tprdump") or looks_like_tpr_dump(path):
        return read_tpr_dump(path)
    raise ValueError(f"unsupported topology format: {path}")


def _box_from_matrix(boxmat: np.ndarray) -> np.ndarray:
    """XTC box matrices -> (F, 3) diagonal lengths when orthorhombic, or
    the full (F, 3, 3) matrix when any off-diagonal is nonzero (triclinic
    minimum image in the distance kernel; dropping the off-diagonals
    would corrupt distances for dodecahedral/octahedral boxes)."""
    diag = np.stack([boxmat[:, 0, 0], boxmat[:, 1, 1], boxmat[:, 2, 2]],
                    axis=1)
    off = boxmat - np.einsum("fi,ij->fij", diag, np.eye(3,
                                                        dtype=boxmat.dtype))
    if np.abs(off).max() > 1e-5 * max(np.abs(diag).max(), 1.0):
        return boxmat
    return diag


def _box_from_unitcell(cell: np.ndarray) -> np.ndarray:
    """DCD unitcell rows [A, g, B, b, C... as stored: A, cos(gamma), B,
    cos(beta), cos(alpha), C] -> (F, 3) lengths or (F, 3, 3) triclinic
    matrix. Angle slots hold cosines (CHARMM) when |x| <= 1, degrees
    otherwise."""
    A, B, C = cell[:, 0], cell[:, 2], cell[:, 5]
    raw = cell[:, [4, 3, 1]]  # cos(alpha), cos(beta), cos(gamma) order
    if np.any((np.abs(raw) <= 1.0) & (raw != 0.0)):
        # the cosine-vs-degrees convention is ambiguous for |x| <= 1: a
        # genuine 1-degree angle stored in degrees would be misread as a
        # cosine. Pathological, but say so instead of silently guessing.
        warnings.warn(
            "DCD unitcell angle fields with |value| <= 1 are interpreted "
            "as cosines (CHARMM convention); boxes with genuine angles "
            "<= 1 degree stored in degrees would be misread",
            stacklevel=3)
    cosv = np.where(np.abs(raw) <= 1.0, raw, np.cos(np.radians(raw)))
    ca, cb, cg = cosv[:, 0], cosv[:, 1], cosv[:, 2]
    if np.abs(cosv).max() < 1e-6:
        return np.stack([A, B, C], axis=1).astype(np.float32)
    return box_from_cosines(A, B, C, ca, cb, cg)


def _open_traj(path: str, natoms: int):
    """Open one trajectory file by extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".xtc":
        return XTCReader(path)
    if ext == ".trr":
        return TRRReader(path)
    if ext == ".dcd":
        return DCDReader(path)
    if ext in (".nc", ".ncdf"):
        return NCDFReader(path)
    if ext == ".mdcrd":
        return MDCRDReader(path, natoms)
    if ext == ".pdb":
        return PDBModelReader(path)
    if ext in (".inpcrd", ".rst7", ".rst"):
        return InpcrdReader(path)
    raise ValueError(f"unsupported trajectory format: {path}")


def _normalized_read(traj, frames):
    """Normalize every reader to (coords, times_ns or None, box or
    None)."""
    if isinstance(traj, (XTCReader, TRRReader)):
        coords, times, boxmat, _ = traj.read(frames)
        return coords, times, _box_from_matrix(boxmat)
    if isinstance(traj, DCDReader):
        coords, cell = traj.read(frames)
        return coords, None, _box_from_unitcell(cell)
    if isinstance(traj, NCDFReader):
        return traj.read(frames)
    if isinstance(traj, _ChainReader):
        return traj.read(frames)
    coords, box = traj.read(frames)   # MDCRD / PDB models / inpcrd
    return coords, None, box


class _ChainReader:
    """Several trajectory files read as one continuous trajectory —
    the MDAnalysis ChainReader pattern (``mda.Universe(top, [t1, t2])``,
    which the reference inherits through contacts.py:246-249). Mixed
    formats are fine as long as atom counts agree; the chain carries
    times only when EVERY segment does (else pass ``dt_ns``)."""

    def __init__(self, paths: Sequence[str], natoms: int):
        self._readers = [_open_traj(p, natoms) for p in paths]
        counts = {r.natoms for r in self._readers}
        if len(counts) != 1:
            raise ValueError(f"chained trajectories disagree on atom "
                             f"count: {sorted(counts)}")
        self.natoms = self._readers[0].natoms
        lens = np.asarray([len(r) for r in self._readers], np.int64)
        if (lens == 0).any():
            empty = [p for p, n in zip(paths, lens) if n == 0]
            raise ValueError(f"chained trajectory segment(s) have no "
                             f"frames: {empty}")
        self._offsets = np.concatenate([[0], np.cumsum(lens)])
        self.nframes = int(self._offsets[-1])
        # decide the time/box contract ONCE so every read() is
        # consistent regardless of which segments a batch happens to
        # touch (a per-read decision would hand adjacent batches times
        # from different sources)
        probes = [_normalized_read(r, [0]) for r in self._readers]
        self._have_times = all(t is not None for _, t, _ in probes)
        self._have_box = all(b is not None for _, _, b in probes)
        if not self._have_box and any(b is not None
                                      for _, _, b in probes):
            warnings.warn(
                "chained trajectory segments disagree on box presence; "
                "the chain reports no box (minimum-image disabled)",
                stacklevel=3)

    def read(self, frames: Optional[Sequence[int]] = None):
        idx = (np.arange(self.nframes) if frames is None
               else np.asarray(frames, np.int64))
        which = np.searchsorted(self._offsets, idx, side="right") - 1
        coords = np.empty((len(idx), self.natoms, 3), np.float32)
        times = np.empty(len(idx), np.float64)
        boxes = [None] * len(idx)
        for seg in np.unique(which):
            sel = np.flatnonzero(which == seg)
            local = idx[sel] - self._offsets[seg]
            c, t, b = _normalized_read(self._readers[seg], local)
            coords[sel] = c
            if self._have_times:
                times[sel] = t
            if self._have_box:
                for j, s in enumerate(sel):
                    boxes[s] = b[j]
        box = None
        if self._have_box:
            if any(bx.ndim == 2 for bx in boxes):
                # mixed diagonal/triclinic segments: promote to matrices
                boxes = [bx if bx.ndim == 2 else np.diag(bx)
                         for bx in boxes]
            box = np.stack(boxes)
        return coords, (times if self._have_times else None), box

    def __len__(self):
        return self.nframes


class Universe:
    """Topology + trajectory pair (or list of chained trajectory
    segments)."""

    def __init__(self, top_path: str, traj_path=None,
                 dcd_dt_ns: Optional[float] = None,
                 dt_ns: Optional[float] = None):
        self.top_path = top_path
        self.traj_path = traj_path
        self.topology = read_topology(top_path)
        self._traj = None
        # dt_ns: explicit frame interval for formats without a time axis
        # (DCD, mdcrd, time-less NetCDF); dcd_dt_ns kept as the original
        # spelling of the same knob
        self._dt_ns = dt_ns if dt_ns is not None else dcd_dt_ns
        if traj_path is not None:
            if isinstance(traj_path, (list, tuple)):
                if len(traj_path) == 1:
                    self._traj = _open_traj(traj_path[0],
                                            self.topology.natoms)
                else:
                    self._traj = _ChainReader(traj_path,
                                              self.topology.natoms)
            else:
                self._traj = _open_traj(traj_path, self.topology.natoms)
            if self._traj.natoms != self.topology.natoms:
                raise ValueError(
                    f"topology has {self.topology.natoms} atoms but "
                    f"trajectory has {self._traj.natoms}")
            if len(self._traj) == 0:
                raise ValueError(f"trajectory has no frames: {traj_path}")
            if self.topology.positions is None:
                # PSF/PRMTOP carry no coordinates: seed the topology
                # with frame 0 so position-dependent selections
                # ('around', 'prop x/y/z') work, MDAnalysis-style
                coords, _, box = self._read_frames([0])
                self.topology.positions = coords[0]
                if self.topology.box is None and box is not None \
                        and box.ndim == 2:
                    self.topology.box = box[0]

    @property
    def n_frames(self) -> int:
        return len(self._traj) if self._traj is not None else 1

    def select_atoms(self, expr: str) -> np.ndarray:
        return self.topology.select(expr)

    # CHARMM DCD headers store the integration step in AKMA time units
    _AKMA_PS = 0.04888821

    def _read_frames(self, frames: Sequence[int]):
        """Normalize every reader to (coords, times_ns or None, box or
        None)."""
        if self._traj is None:
            coords = np.tile(self.topology.positions[None],
                             (len(frames), 1, 1))
            box = (np.tile(self.topology.box, (len(frames), 1))
                   if self.topology.box is not None else None)
            return coords, None, box
        return _normalized_read(self._traj, frames)

    def timestep_ns(self) -> float:
        """Frame interval in ns (the reference's ts = dt/1000,
        contacts.py:83)."""
        if self._traj is not None and len(self._traj) > 1:
            _, t, _ = self._read_frames([0, 1])
            if t is not None:
                dt = float(t[1] - t[0])
                if dt <= 0:
                    raise ValueError(
                        f"non-increasing frame times (dt = {dt} ns "
                        "between frames 0 and 1 — restarted segment "
                        "clocks?); pass Universe(..., dt_ns=...) "
                        "(CLI: --dt) explicitly")
                return dt
        if self._dt_ns is not None:
            return self._dt_ns
        if isinstance(self._traj, DCDReader):
            if self._traj.charmm:
                # header delta [AKMA] x frames-between-saves -> ns
                return float(self._traj.delta * max(self._traj.nsavc, 1)
                             * self._AKMA_PS / 1000.0)
            raise ValueError(
                "cannot infer the frame interval from a non-CHARMM DCD "
                "header (delta units are writer-dependent); pass "
                "Universe(..., dcd_dt_ns=...) (CLI: --dt) explicitly")
        if isinstance(self._traj, (MDCRDReader, NCDFReader,
                                   PDBModelReader, _ChainReader)):
            raise ValueError(
                f"{type(self._traj).__name__} carries no usable time "
                "axis; pass Universe(..., dt_ns=...) (CLI: --dt) "
                "explicitly")
        return 1.0

    def frame_positions(self, frames: Sequence[int]) -> np.ndarray:
        """(F, A, 3) coordinates [Angstrom] of the given frames."""
        return self._read_frames(frames)[0]

    def iter_batches(self, batch_size: int = 32,
                     frames: Optional[Sequence[int]] = None
                     ) -> Iterator[FrameBatch]:
        """Yield FrameBatch chunks for the contact mapper."""
        if frames is None:
            frames = np.arange(self.n_frames)
        frames = np.asarray(frames)
        ts = self.timestep_ns()
        for lo in range(0, len(frames), batch_size):
            chunk = frames[lo:lo + batch_size]
            coords, times, box = self._read_frames(chunk)
            if times is None:
                times = chunk * ts
            yield FrameBatch(frame_ids=chunk.astype(np.int64),
                             times=np.asarray(times, np.float64),
                             positions=coords, box=box)
