"""ctypes bindings to the native MD I/O library (native/mdio.cpp).

The library is built at first use with g++ (no pybind11) into the
package's ``build/`` directory, keyed by a hash of the sources and the
flags, so an edited source never meets a stale library. Coordinates are
exposed in Angstrom and times in ns framework-wide; XTC's native nm/ps
are converted here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

# sources ship inside the package so installed wheels can build the codec
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_SOURCES = ("mdio.cpp", "xdrf.cpp")
_HEADERS = ("xdrf.h",)
_CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")
_lib = None


def build_library() -> str:
    """Compile ``native/*.cpp`` into ``build/`` unless the library of
    these very sources and flags exists; returns its path."""
    h = hashlib.sha1(" ".join(_CXXFLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    out = os.path.join(_BUILD_DIR, f"libmdio_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp,
           *(os.path.join(_NATIVE_DIR, s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the trajectory codec failed "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)     # atomic: a concurrent build loses nothing
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    c = ctypes
    lib.bmd_xtc_open.restype = c.c_void_p
    lib.bmd_xtc_open.argtypes = [c.c_char_p]
    lib.bmd_xtc_natoms.restype = c.c_int
    lib.bmd_xtc_natoms.argtypes = [c.c_void_p]
    lib.bmd_xtc_nframes.restype = c.c_long
    lib.bmd_xtc_nframes.argtypes = [c.c_void_p]
    lib.bmd_xtc_read.restype = c.c_long
    lib.bmd_xtc_read.argtypes = [c.c_void_p, c.POINTER(c.c_long), c.c_long,
                                 c.POINTER(c.c_float), c.POINTER(c.c_float),
                                 c.POINTER(c.c_int), c.POINTER(c.c_float)]
    lib.bmd_xtc_close.argtypes = [c.c_void_p]
    lib.bmd_xtc_write.restype = c.c_long
    lib.bmd_xtc_write.argtypes = [c.c_char_p, c.c_int, c.c_long,
                                  c.POINTER(c.c_float), c.POINTER(c.c_float),
                                  c.POINTER(c.c_int), c.POINTER(c.c_float),
                                  c.c_float, c.c_int]
    lib.bmd_trr_open.restype = c.c_void_p
    lib.bmd_trr_open.argtypes = [c.c_char_p]
    lib.bmd_trr_natoms.restype = c.c_int
    lib.bmd_trr_natoms.argtypes = [c.c_void_p]
    lib.bmd_trr_nframes.restype = c.c_long
    lib.bmd_trr_nframes.argtypes = [c.c_void_p]
    lib.bmd_trr_read.restype = c.c_long
    lib.bmd_trr_read.argtypes = [c.c_void_p, c.POINTER(c.c_long), c.c_long,
                                 c.POINTER(c.c_float), c.POINTER(c.c_float),
                                 c.POINTER(c.c_int), c.POINTER(c.c_float)]
    lib.bmd_trr_close.argtypes = [c.c_void_p]
    lib.bmd_trr_write.restype = c.c_long
    lib.bmd_trr_write.argtypes = [c.c_char_p, c.c_int, c.c_long,
                                  c.POINTER(c.c_float), c.POINTER(c.c_float),
                                  c.POINTER(c.c_int), c.POINTER(c.c_float),
                                  c.c_int]
    lib.bmd_dcd_open.restype = c.c_void_p
    lib.bmd_dcd_open.argtypes = [c.c_char_p]
    lib.bmd_dcd_natoms.restype = c.c_int
    lib.bmd_dcd_natoms.argtypes = [c.c_void_p]
    lib.bmd_dcd_nframes.restype = c.c_long
    lib.bmd_dcd_nframes.argtypes = [c.c_void_p]
    lib.bmd_dcd_delta.restype = c.c_float
    lib.bmd_dcd_delta.argtypes = [c.c_void_p]
    lib.bmd_dcd_nsavc.restype = c.c_int
    lib.bmd_dcd_nsavc.argtypes = [c.c_void_p]
    lib.bmd_dcd_charmm.restype = c.c_int
    lib.bmd_dcd_charmm.argtypes = [c.c_void_p]
    lib.bmd_dcd_read.restype = c.c_long
    lib.bmd_dcd_read.argtypes = [c.c_void_p, c.POINTER(c.c_long), c.c_long,
                                 c.POINTER(c.c_float), c.POINTER(c.c_double)]
    lib.bmd_dcd_close.argtypes = [c.c_void_p]
    lib.bmd_dcd_write.restype = c.c_long
    lib.bmd_dcd_write.argtypes = [c.c_char_p, c.c_int, c.c_long,
                                  c.POINTER(c.c_float), c.POINTER(c.c_double),
                                  c.c_float, c.c_int, c.c_int]
    _lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class XTCReader:
    """Random-access XTC reader (frame offsets indexed at open)."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.bmd_xtc_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open XTC file: {path}")
        self.natoms = self._lib.bmd_xtc_natoms(self._h)
        self.nframes = self._lib.bmd_xtc_nframes(self._h)

    def read(self, frames: Optional[Sequence[int]] = None):
        """Read frames (default all).

        Returns:
            coords (F, natoms, 3) float32 [Angstrom],
            times (F,) float64 [ns],
            box (F, 3, 3) float32 [Angstrom],
            steps (F,) int32.
        """
        if frames is None:
            frames = np.arange(self.nframes)
        idx = np.ascontiguousarray(frames, dtype=np.int64)
        F = len(idx)
        coords = np.empty((F, self.natoms, 3), np.float32)
        times = np.empty(F, np.float32)
        steps = np.empty(F, np.int32)
        box = np.empty((F, 3, 3), np.float32)
        got = self._lib.bmd_xtc_read(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), F,
            _fptr(coords), _fptr(times),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _fptr(box))
        if got != F:
            raise IOError(f"XTC read failed with code {got}")
        return (coords * 10.0, times.astype(np.float64) / 1000.0,
                box * 10.0, steps)

    def close(self):
        if self._h:
            self._lib.bmd_xtc_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __len__(self):
        return self.nframes


class XTCWriter:
    """XTC writer (Angstrom/ns in, nm/ps on disk; precision 1000/nm)."""

    def __init__(self, path: str, precision: float = 1000.0):
        self.path = path
        self.precision = precision
        self._first = True

    def write(self, coords: np.ndarray, times: np.ndarray,
              box: np.ndarray, steps: Optional[np.ndarray] = None):
        """coords (F, A, 3) Angstrom; times (F,) ns; box (F, 3, 3) or (F, 3)
        Angstrom (diagonal)."""
        lib = _load()
        coords = np.ascontiguousarray(coords, np.float32) / 10.0
        F, A, _ = coords.shape
        times_ps = np.ascontiguousarray(times, np.float32) * 1000.0
        box = np.asarray(box, np.float32)
        if box.ndim == 2:  # diagonal lengths -> full matrix
            full = np.zeros((F, 3, 3), np.float32)
            full[:, 0, 0] = box[:, 0]
            full[:, 1, 1] = box[:, 1]
            full[:, 2, 2] = box[:, 2]
            box = full
        box = np.ascontiguousarray(box / 10.0)
        if steps is None:
            steps = np.arange(F, dtype=np.int32)
        steps = np.ascontiguousarray(steps, np.int32)
        got = lib.bmd_xtc_write(
            self.path.encode(), A, F, _fptr(coords), _fptr(times_ps),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _fptr(box),
            self.precision, 0 if self._first else 1)
        self._first = False
        if got != F:
            raise IOError(f"XTC write failed with code {got}")

    def close(self):
        """Frames flush per write(); nothing buffered."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class TRRReader:
    """Random-access TRR reader (frame offsets indexed at open).

    Same big-endian XDR wire format as XTC without the 3dfcoord
    compression (reference reach: contacts.py:246-249 accepts every
    format MDAnalysis reads; TRR is the common full-precision one).
    Single- and double-precision files both decode (to float32).
    """

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.bmd_trr_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open TRR file: {path}")
        self.natoms = self._lib.bmd_trr_natoms(self._h)
        self.nframes = self._lib.bmd_trr_nframes(self._h)

    def read(self, frames: Optional[Sequence[int]] = None):
        """Read frames (default all).

        Returns:
            coords (F, natoms, 3) float32 [Angstrom],
            times (F,) float64 [ns],
            box (F, 3, 3) float32 [Angstrom],
            steps (F,) int32.
        """
        if frames is None:
            frames = np.arange(self.nframes)
        idx = np.ascontiguousarray(frames, dtype=np.int64)
        F = len(idx)
        coords = np.empty((F, self.natoms, 3), np.float32)
        times = np.empty(F, np.float32)
        steps = np.empty(F, np.int32)
        box = np.empty((F, 3, 3), np.float32)
        got = self._lib.bmd_trr_read(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), F,
            _fptr(coords), _fptr(times),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _fptr(box))
        if got != F:
            if got == -5:
                raise IOError("TRR frame carries no coordinates (velocity/"
                              "force-only frame)")
            raise IOError(f"TRR read failed with code {got}")
        return (coords * 10.0, times.astype(np.float64) / 1000.0,
                box * 10.0, steps)

    def close(self):
        if self._h:
            self._lib.bmd_trr_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __len__(self):
        return self.nframes


class TRRWriter:
    """TRR writer (Angstrom/ns in, nm/ps on disk; single precision,
    box + coordinates only)."""

    def __init__(self, path: str):
        self.path = path
        self._first = True

    def write(self, coords: np.ndarray, times: np.ndarray,
              box: np.ndarray, steps: Optional[np.ndarray] = None):
        """coords (F, A, 3) Angstrom; times (F,) ns; box (F, 3, 3) or
        (F, 3) Angstrom (diagonal)."""
        lib = _load()
        coords = np.ascontiguousarray(coords, np.float32) / 10.0
        F, A, _ = coords.shape
        times_ps = np.ascontiguousarray(times, np.float32) * 1000.0
        box = np.asarray(box, np.float32)
        if box.ndim == 2:  # diagonal lengths -> full matrix
            full = np.zeros((F, 3, 3), np.float32)
            full[:, 0, 0] = box[:, 0]
            full[:, 1, 1] = box[:, 1]
            full[:, 2, 2] = box[:, 2]
            box = full
        box = np.ascontiguousarray(box / 10.0)
        if steps is None:
            steps = np.arange(F, dtype=np.int32)
        steps = np.ascontiguousarray(steps, np.int32)
        got = lib.bmd_trr_write(
            self.path.encode(), A, F, _fptr(coords), _fptr(times_ps),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _fptr(box),
            0 if self._first else 1)
        self._first = False
        if got != F:
            raise IOError(f"TRR write failed with code {got}")

    def close(self):
        """Frames flush per write(); nothing buffered."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class DCDReader:
    """Random-access DCD reader."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.bmd_dcd_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open DCD file: {path}")
        self.natoms = self._lib.bmd_dcd_natoms(self._h)
        self.nframes = self._lib.bmd_dcd_nframes(self._h)
        self.delta = float(self._lib.bmd_dcd_delta(self._h))
        self.nsavc = int(self._lib.bmd_dcd_nsavc(self._h))
        self.charmm = int(self._lib.bmd_dcd_charmm(self._h))

    def read(self, frames: Optional[Sequence[int]] = None):
        """Returns coords (F, A, 3) float32 [Angstrom] and unitcell
        (F, 6) float64 rows [A, cos(gamma), B, cos(beta), cos(alpha), C]."""
        if frames is None:
            frames = np.arange(self.nframes)
        idx = np.ascontiguousarray(frames, dtype=np.int64)
        F = len(idx)
        coords = np.empty((F, self.natoms, 3), np.float32)
        cell = np.empty((F, 6), np.float64)
        got = self._lib.bmd_dcd_read(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), F,
            _fptr(coords),
            cell.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if got != F:
            raise IOError(f"DCD read failed with code {got}")
        return coords, cell

    def close(self):
        if self._h:
            self._lib.bmd_dcd_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __len__(self):
        return self.nframes


class DCDWriter:
    """One-shot DCD writer."""

    def __init__(self, path: str, delta: float = 1.0, istart: int = 0,
                 nsavc: int = 1):
        self.path = path
        self.delta = delta
        self.istart = istart
        self.nsavc = nsavc

    def write(self, coords: np.ndarray, box: Optional[np.ndarray] = None):
        """coords (F, A, 3) Angstrom; box (F, 3) diagonal lengths or None."""
        lib = _load()
        coords = np.ascontiguousarray(coords, np.float32)
        F, A, _ = coords.shape
        cell_ptr = None
        if box is not None:
            box = np.asarray(box, np.float64)
            cell = np.zeros((F, 6), np.float64)
            cell[:, 0] = box[:, 0]
            cell[:, 2] = box[:, 1]
            cell[:, 5] = box[:, 2]
            cell = np.ascontiguousarray(cell)
            cell_ptr = cell.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        got = lib.bmd_dcd_write(self.path.encode(), A, F, _fptr(coords),
                                cell_ptr, self.delta, self.istart,
                                self.nsavc)
        if got != F:
            raise IOError(f"DCD write failed with code {got}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class BufferedDCDWriter:
    """Chunk-append facade over the one-shot DCD codec.

    DCD puts the frame count in its header, so chunks accumulate in RAM
    and flush once on :meth:`close`. The format has no per-frame times —
    only the header interval (delta, AKMA units; what ``Universe`` reads
    back, io/universe.py ``timestep_ns``). Pass the source trajectory's
    ``dt_ns`` explicitly when the written frames are non-contiguous
    (top-N / per-component selections): the fallback inference from the
    first two frame times is only meaningful for consecutive frames
    (1 ns when unknowable).
    """

    _AKMA_PS = 0.04888821  # CHARMM AKMA time unit in ps

    def __init__(self, path: str, dt_ns: Optional[float] = None):
        self.path = path
        self.dt_ns = dt_ns
        self._coords: list = []
        self._boxes: list = []
        self._t0 = None
        self._t1 = None
        self._closed = False

    def write(self, coords: np.ndarray, times: np.ndarray,
              box: np.ndarray, steps: Optional[np.ndarray] = None):
        """Same signature as XTCWriter/TRRWriter (steps are meaningless in
        DCD and ignored); coords/box in Angstrom, times in ns."""
        if self._closed:
            raise ValueError(f"write() after close() on {self.path}")
        coords = np.asarray(coords, np.float32)
        box = np.asarray(box, np.float64)
        if box.ndim == 3:                     # full matrix -> diagonal
            box = box[:, (0, 1, 2), (0, 1, 2)]
        self._coords.append(coords)
        self._boxes.append(np.broadcast_to(
            box, (len(coords), 3)).astype(np.float64))
        times = np.asarray(times, np.float64)
        if len(times):
            if self._t0 is None:
                self._t0 = float(times[0])
            elif self._t1 is None:
                self._t1 = float(times[0])
            if self._t1 is None and len(times) > 1:
                self._t1 = float(times[1])

    def close(self):
        if self._closed:
            return
        self._closed = True
        if not self._coords:
            return
        if self.dt_ns is not None:
            dt_ns = float(self.dt_ns)
        else:
            dt_ns = (abs(self._t1 - self._t0)
                     if self._t0 is not None and self._t1 is not None
                     and self._t1 != self._t0 else 1.0)
        delta = dt_ns * 1000.0 / self._AKMA_PS
        DCDWriter(self.path, delta=delta, nsavc=1).write(
            np.concatenate(self._coords), np.concatenate(self._boxes))
        self._coords = []
        self._boxes = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


TRAJ_WRITE_FORMATS = ("xtc", "trr", "dcd", "nc", "ncdf")


def trajectory_writer(path: str, dt_ns: Optional[float] = None):
    """Writer for ``path`` picked by extension (.xtc/.trr/.dcd/.nc).

    All share the chunk-append interface
    ``write(coords, times, box, steps=None)`` (Angstrom/ns) and flush on
    ``close()``/context exit — the reference gets this dispatch from
    ``mda.Writer`` (reference kinetics.py:106-125 writes whatever
    extension the name carries). ``dt_ns`` seeds the DCD header interval
    (XTC/TRR/NetCDF carry true per-frame times and ignore it).
    """
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "xtc":
        return XTCWriter(path)
    if ext == "trr":
        return TRRWriter(path)
    if ext == "dcd":
        return BufferedDCDWriter(path, dt_ns=dt_ns)
    if ext in ("nc", "ncdf"):
        from basicrta_torch.io.amber import NCDFWriter
        return NCDFWriter(path)
    raise ValueError(f"no trajectory writer for '.{ext}' "
                     f"(supported: {', '.join(TRAJ_WRITE_FORMATS)})")
