"""Amber file formats: PRMTOP topologies, NetCDF and ASCII trajectories.

The reference inherits Amber support from MDAnalysis
(reference contacts.py:246-249 / kinetics.py:29-37 build ``mda.Universe``
from any format it reads). Amber's trajectory convention is NetCDF-3
(64-bit offset), which ``scipy.io.netcdf_file`` reads without any new
dependency; PRMTOP and mdcrd are text parses.

Readers follow the package reader protocol (``natoms``, ``__len__``,
``read(frames)``) used by :class:`basicrta_torch.io.universe.Universe`.
"""

from __future__ import annotations

import re
import warnings
from typing import Optional, Sequence

import numpy as np

from basicrta_torch.io.topology import (Topology, _InMemoryFrames,
                                      box_from_cosines)

# ------------------------------ PRMTOP ----------------------------------- #

_FORMAT_RE = re.compile(r"%FORMAT\(\s*(\d+)?\s*([aAiIeEfF])(\d+)")


def _prmtop_sections(path: str):
    """Yield (flag, format_width, [data lines]) per %FLAG section."""
    flag, width, data = None, None, []
    with open(path) as f:
        for ln in f:
            ln = ln.rstrip("\n")
            if ln.startswith("%FLAG"):
                if flag is not None:
                    yield flag, width, data
                flag, width, data = ln.split()[1], None, []
            elif ln.startswith("%FORMAT"):
                m = _FORMAT_RE.match(ln)
                if m:
                    width = int(m.group(3))
            elif ln.startswith("%"):
                continue  # %COMMENT / %VERSION
            elif flag is not None:
                data.append(ln)
    if flag is not None:
        yield flag, width, data


def _fixed_fields(lines, width):
    """Split fixed-width records (fields may abut with no whitespace)."""
    out = []
    for ln in lines:
        out.extend(ln[i:i + width] for i in range(0, len(ln), width))
    return out


def read_prmtop(path: str) -> Topology:
    """Parse an Amber PRMTOP/parm7 topology.

    Uses ATOM_NAME (20a4), RESIDUE_LABEL (20a4) and RESIDUE_POINTER
    (10I8, 1-based first-atom index per residue). PRMTOP carries no
    coordinates or box — pair with a NetCDF/mdcrd trajectory or an
    inpcrd-derived PDB.
    """
    names = resnames_r = pointers = None
    charges = masses = types = None
    with open(path) as f:
        if not f.readline().startswith("%VERSION"):
            raise ValueError(f"{path} is not a PRMTOP file (missing "
                             "%VERSION header)")
    for flag, width, data in _prmtop_sections(path):
        if flag == "ATOM_NAME":
            names = [s.strip() for s in _fixed_fields(data, width or 4)
                     if s.strip()]
        elif flag == "RESIDUE_LABEL":
            resnames_r = [s.strip() for s in _fixed_fields(data, width or 4)
                          if s.strip()]
        elif flag == "RESIDUE_POINTER":
            pointers = [int(s) for s in " ".join(data).split()]
        elif flag == "CHARGE":
            # PRMTOP stores q * 18.2223 (kcal/mol internal units) -> e
            charges = (np.asarray(" ".join(data).split(), np.float64)
                       / 18.2223)
        elif flag == "MASS":
            masses = np.asarray(" ".join(data).split(), np.float64)
        elif flag == "AMBER_ATOM_TYPE":
            types = [s.strip() for s in _fixed_fields(data, width or 4)
                     if s.strip()]
    if names is None or resnames_r is None or pointers is None:
        raise ValueError(f"{path}: missing ATOM_NAME / RESIDUE_LABEL / "
                         "RESIDUE_POINTER sections")
    natoms = len(names)
    starts = np.asarray(pointers, np.int64) - 1          # 0-based
    ends = np.append(starts[1:], natoms)
    resids = np.empty(natoms, np.int32)
    resnames = np.empty(natoms, dtype=object)
    for r, (lo, hi) in enumerate(zip(starts, ends)):
        resids[lo:hi] = r + 1                            # Amber is 1-based
        resnames[lo:hi] = resnames_r[r]
    return Topology(np.asarray(names), resids,
                    resnames.astype(str), positions=None, box=None,
                    masses=(None if masses is None
                            else masses.astype(np.float32)),
                    charges=(None if charges is None
                             else charges.astype(np.float32)),
                    types=(None if types is None else np.asarray(types)))


# --------------------------- NetCDF trajectory ---------------------------- #

def _cell_to_box(lengths: np.ndarray, angles_deg: Optional[np.ndarray]
                 ) -> np.ndarray:
    """(F, 3) lengths [+ (F, 3) angles in degrees] -> (F, 3) diagonal
    lengths when orthorhombic, else the (F, 3, 3) triclinic row matrix
    the distance kernel takes."""
    lengths = np.asarray(lengths, np.float32)
    if angles_deg is None or np.allclose(angles_deg, 90.0, atol=1e-4):
        return lengths
    ang = np.radians(np.asarray(angles_deg, np.float64))
    A, B, C = (lengths[:, i].astype(np.float64) for i in range(3))
    return box_from_cosines(A, B, C, np.cos(ang[:, 0]), np.cos(ang[:, 1]),
                            np.cos(ang[:, 2]))


class NCDFReader:
    """Amber NetCDF trajectory (AMBER convention, NetCDF-3).

    ``read(frames)`` returns ``(coords (F, A, 3) float32 [Angstrom],
    times (F,) float64 [ns] or None, box (F, 3) / (F, 3, 3) or None)``.
    """

    def __init__(self, path: str):
        from scipy.io import netcdf_file
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic.startswith(b"\x89HDF"):
            raise ValueError(
                f"{path} is a NetCDF-4/HDF5 file; the Amber convention "
                "and this reader use NetCDF-3 — convert with cpptraj "
                "(trajout ... netcdf)")
        self._nc = netcdf_file(path, "r", mmap=True)
        conv = getattr(self._nc, "Conventions", b"")
        conv = conv.decode() if isinstance(conv, bytes) else str(conv)
        if "AMBER" not in conv.upper():
            warnings.warn(f"{path}: Conventions={conv!r} does not declare "
                          "AMBER; reading as an Amber trajectory anyway")
        v = self._nc.variables
        if "coordinates" not in v:
            raise ValueError(f"{path}: no 'coordinates' variable")
        self._coords = v["coordinates"]
        self._time = v.get("time")
        self._lengths = v.get("cell_lengths")
        self._angles = v.get("cell_angles")
        self.natoms = self._coords.shape[1]
        self.nframes = self._coords.shape[0]

    @staticmethod
    def _scale(var) -> float:
        s = getattr(var, "scale_factor", 1.0)
        return float(s[0] if np.ndim(s) else s)

    def read(self, frames: Optional[Sequence[int]] = None):
        idx = (np.arange(self.nframes) if frames is None
               else np.asarray(frames, np.int64))
        coords = (self._coords[idx].astype(np.float32)
                  * self._scale(self._coords))
        times = None
        if self._time is not None:
            # convention stores picoseconds
            times = (self._time[idx].astype(np.float64)
                     * self._scale(self._time) / 1000.0)
        box = None
        if self._lengths is not None:
            lengths = (self._lengths[idx].astype(np.float32)
                       * self._scale(self._lengths))
            angles = (self._angles[idx].astype(np.float64)
                      * self._scale(self._angles)
                      if self._angles is not None else None)
            box = _cell_to_box(lengths, angles)
        return coords, times, box

    def close(self):
        if self._nc is not None:
            # drop the mmap-backed variable views first so scipy can
            # unmap cleanly (read() hands out copies only)
            self._coords = self._time = None
            self._lengths = self._angles = None
            self._nc.close()
            self._nc = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (interpreter teardown)
            pass

    def __len__(self):
        return self.nframes


def _box_to_cell(box: np.ndarray):
    """(F, 3) diagonal lengths or (F, 3, 3) triclinic row matrix ->
    (lengths (F, 3), angles (F, 3) degrees)."""
    box = np.asarray(box, np.float64)
    if box.ndim == 2:
        return box, np.full_like(box, 90.0)
    lengths = np.linalg.norm(box, axis=-1)                  # row norms
    a, b, c = box[:, 0], box[:, 1], box[:, 2]

    def angle(u, v, lu, lv):
        cosv = (u * v).sum(-1) / np.maximum(lu * lv, 1e-12)
        return np.degrees(np.arccos(np.clip(cosv, -1.0, 1.0)))
    alpha = angle(b, c, lengths[:, 1], lengths[:, 2])
    beta = angle(a, c, lengths[:, 0], lengths[:, 2])
    gamma = angle(a, b, lengths[:, 0], lengths[:, 1])
    return lengths, np.stack([alpha, beta, gamma], axis=1)


class NCDFWriter:
    """Amber NetCDF trajectory writer (AMBER convention 1.0, NetCDF-3
    64-bit offset via scipy — the symmetric counterpart of
    :class:`NCDFReader`, so Amber users get reduced kinetics
    trajectories back in their native format; the reference gets this
    from ``mda.Writer``, reference kinetics.py:106-125).

    Chunk-append interface shared with XTC/TRR/DCD writers:
    ``write(coords, times, box, steps=None)`` with coords/box in
    Angstrom and times in ns (stored as picoseconds per the
    convention); flush on ``close()``/context exit. The first chunk
    decides whether the file carries cell variables; later chunks must
    agree (the convention has no per-frame presence flag).
    """

    def __init__(self, path: str, title: str = "basicrta_torch"):
        self.path = path
        self.title = title
        self._coords: list = []
        self._times: list = []
        self._lengths: list = []
        self._angles: list = []
        self._has_box: Optional[bool] = None
        self._closed = False

    def write(self, coords: np.ndarray, times: np.ndarray,
              box: Optional[np.ndarray], steps=None):
        if self._closed:
            raise ValueError("NCDFWriter: write() after close()")
        coords = np.asarray(coords, np.float32)
        if self._has_box is None:
            self._has_box = box is not None
        elif self._has_box != (box is not None):
            raise ValueError(
                "NCDFWriter: all chunks must agree on having a box "
                "(the AMBER convention has no per-frame cell flag)")
        self._coords.append(coords)
        self._times.append(np.broadcast_to(
            np.asarray(times, np.float64), (len(coords),)).copy())
        if box is not None:
            lengths, angles = _box_to_cell(box)
            self._lengths.append(np.broadcast_to(
                lengths, (len(coords), 3)).astype(np.float64))
            self._angles.append(np.broadcast_to(
                angles, (len(coords), 3)).astype(np.float64))

    def close(self):
        if self._closed:
            return
        self._closed = True
        from scipy.io import netcdf_file
        coords = (np.concatenate(self._coords) if self._coords
                  else np.zeros((0, 0, 3), np.float32))
        F, A = coords.shape[:2]
        nc = netcdf_file(self.path, "w", version=2)   # 64-bit offset
        try:
            nc.Conventions = "AMBER"
            nc.ConventionVersion = "1.0"
            nc.program = "basicrta_torch"
            nc.programVersion = "0"
            nc.title = self.title
            nc.createDimension("frame", None)         # unlimited
            nc.createDimension("spatial", 3)
            nc.createDimension("atom", A)
            sp = nc.createVariable("spatial", "c", ("spatial",))
            # 'c' variables hold S1 chars; assigning ints would stringify
            # (120 -> b'1'), so hand scipy byte chars
            sp[:] = np.frombuffer(b"xyz", dtype="S1")
            t = nc.createVariable("time", "f", ("frame",))
            t.units = "picosecond"
            c = nc.createVariable("coordinates", "f",
                                  ("frame", "atom", "spatial"))
            c.units = "angstrom"
            if F:
                t[0:F] = (np.concatenate(self._times) * 1000.0).astype(
                    np.float32)
                c[0:F] = coords
            if self._has_box:
                nc.createDimension("cell_spatial", 3)
                nc.createDimension("cell_angular", 3)
                nc.createDimension("label", 5)
                cs = nc.createVariable("cell_spatial", "c",
                                       ("cell_spatial",))
                cs[:] = np.frombuffer(b"abc", dtype="S1")
                cg = nc.createVariable("cell_angular", "c",
                                       ("cell_angular", "label"))
                cg[:] = np.frombuffer(b"alphabeta gamma",
                                      dtype="S1").reshape(3, 5)
                cl = nc.createVariable("cell_lengths", "d",
                                       ("frame", "cell_spatial"))
                cl.units = "angstrom"
                ca = nc.createVariable("cell_angles", "d",
                                       ("frame", "cell_angular"))
                ca.units = "degree"
                if F:
                    cl[0:F] = np.concatenate(self._lengths)
                    ca[0:F] = np.concatenate(self._angles)
        finally:
            nc.close()
        self._coords, self._times = [], []
        self._lengths, self._angles = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------- ASCII mdcrd --------------------------------- #

class MDCRDReader(_InMemoryFrames):
    """Amber ASCII trajectory (mdcrd, 10F8.3).

    Layout: one title line, then per frame ceil(3*natoms/10) coordinate
    lines, optionally followed by one 3-value box-length line (written
    when the run was periodic). ``has_box=None`` auto-detects from the
    line count; pass it explicitly when detection reports ambiguity.
    The whole file parses once into memory (ASCII trajectories are
    small by construction). mdcrd carries no time axis — give the frame
    interval to ``Universe(..., dt_ns=...)``. Box lines hold lengths
    only (orthorhombic); truncated-octahedron mdcrd needs NetCDF.
    ``read(frames)`` returns ``(coords, box (F, 3) or None)``.
    """

    def __init__(self, path: str, natoms: int,
                 has_box: Optional[bool] = None):
        self.natoms = int(natoms)
        with open(path) as f:
            lines = f.read().splitlines()
        data = lines[1:]
        while data and not data[-1].strip():
            data.pop()
        cl = -(-3 * self.natoms // 10)           # coord lines per frame
        if has_box is None:
            fits_plain = len(data) % cl == 0
            fits_box = len(data) % (cl + 1) == 0
            if fits_plain and fits_box and len(data):
                if self.natoms == 1:
                    # 1 atom: coordinate and box lines both hold 3
                    # fields, so nothing distinguishes the layouts
                    raise ValueError(
                        f"{path}: box detection is ambiguous for "
                        "natoms=1; pass has_box explicitly")
                # both layouts divide: a box line has exactly 3 fields
                # where a coordinate line at that position would have 10
                # (or the frame's 3N%10 remainder, which is never 3 when
                # the ambiguity can arise for natoms > 1)
                probe = self._fields(data[cl]) if cl < len(data) else []
                has_box = len(probe) == 3
            elif fits_box:
                has_box = True
            elif fits_plain:
                has_box = False
            else:
                raise ValueError(
                    f"{path}: {len(data)} data lines fit neither "
                    f"{cl} nor {cl + 1} lines/frame for natoms={natoms}; "
                    "is the topology right?")
        self.has_box = bool(has_box)
        per = cl + (1 if self.has_box else 0)
        if len(data) % per:
            raise ValueError(f"{path}: truncated final frame "
                             f"({len(data)} lines, {per}/frame)")
        self.nframes = len(data) // per
        vals = np.empty((self.nframes, 3 * self.natoms), np.float32)
        box = (np.empty((self.nframes, 3), np.float32)
               if self.has_box else None)
        for fr in range(self.nframes):
            chunk = data[fr * per:(fr + 1) * per]
            flat = [v for ln in chunk[:cl] for v in self._fields(ln)]
            vals[fr] = np.asarray(flat, np.float32)
            if self.has_box:
                bf = self._fields(chunk[cl])
                if len(bf) != 3:
                    raise ValueError(
                        f"{path}: frame {fr}: expected a 3-value box "
                        f"line, got {len(bf)} fields — truncated or "
                        "garbled file, or pass has_box explicitly")
                box[fr] = np.asarray(bf, np.float32)
        self._coords = vals.reshape(self.nframes, self.natoms, 3)
        self._box = box

    @staticmethod
    def _fields(ln: str, width: int = 8):
        """Fixed-width F8.3 fields (they abut with no whitespace when a
        value fills its 8 columns, so split() is not safe)."""
        return [ln[i:i + width] for i in range(0, len(ln.rstrip()), width)]


# --------------------------- inpcrd / restart ------------------------------ #

class InpcrdReader(_InMemoryFrames):
    """Amber ASCII restart/coordinate file (.inpcrd/.rst7) as a one-frame
    trajectory — the standard companion of a PRMTOP (reference reach:
    ``mda.Universe(prmtop, inpcrd)``).

    Layout: title line; natoms [time] line; coordinates 6F12.7;
    optionally velocities (same size) and/or one 6-value box line
    (3 lengths + 3 angles). The value count distinguishes the variants
    (3N / 3N+6 / 6N / 6N+6); the degenerate natoms=2 file (where
    3N+6 == 6N) is resolved in favor of coordinates+box, Amber's
    overwhelmingly common restart shape. ``read(frames)`` returns
    ``(coords (1, A, 3), box (1, 3) or (1, 3, 3) or None)``.
    """

    def __init__(self, path: str):
        with open(path) as f:
            f.readline()                          # title
            hdr = f.readline().split()
            if not hdr:
                raise ValueError(f"{path}: missing natoms line")
            self.natoms = int(hdr[0])
            body = f.read()
        # 12-char fixed-width fields (they abut when values fill the
        # width), line by line
        vals = []
        for ln in body.splitlines():
            ln = ln.rstrip()
            vals.extend(float(ln[i:i + 12])
                        for i in range(0, len(ln), 12))
        n = self.natoms
        nv = len(vals)
        if nv == 3 * n:
            has_vel = has_box = False
        elif nv == 6 * n and n != 2:
            has_vel, has_box = True, False
        elif nv == 3 * n + 6:
            has_vel, has_box = False, True
        elif nv == 6 * n + 6:
            has_vel, has_box = True, True
        else:
            raise ValueError(
                f"{path}: {nv} values do not fit natoms={n} with or "
                "without velocities/box")
        del has_vel  # velocities are parsed past, never used
        coords = np.asarray(vals[:3 * n], np.float32).reshape(1, n, 3)
        box = None
        if has_box:
            lengths = np.asarray(vals[-6:-3], np.float32)[None]
            angles = np.asarray(vals[-3:], np.float64)[None]
            box = _cell_to_box(lengths, angles)
        self._coords, self._box = coords, box
        self.nframes = 1
