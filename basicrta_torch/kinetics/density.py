"""Weighted volumetric densities as device scatter-adds.

Port of ``basicrta_tpu.kinetics.density`` (reference pwdensity.py:254-264,
wdensity.py:256-264 loop ``np.histogramdd`` per frame, adding ``w_k * h``
into one grid per mixture component). Here every frame and component of a
chunk lands in one ``index_add_``: atom positions are voxelised, the flat
voxel ids offset per component, and the frame weights scattered into one
(K, nvox + 1) f32 buffer that stays on the device across chunks. The grids
come back to the host once, in :meth:`GridAccumulator.finish`. Plain torch
ops; the card runs them unless the caller names the CPU.

f32 atomics on the card do not sum in the host's order, so grids agree
with the JAX package's to a tolerance (rtol 1e-5 of a grid's largest
value), not bit for bit.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from basicrta_torch.io.dx import write_dx


def fixedwidth_bins(delta: float, smin: np.ndarray, smax: np.ndarray):
    """Bin layout covering [smin, smax] with exact-width delta bins,
    centered on the range (MDAnalysis fixedwidth_bins semantics used by
    reference wdensity.py:244-247)."""
    length = smax - smin
    n = np.ceil(length / delta).astype(int)
    dx = 0.5 * (n * delta - length)
    return n, smin - dx, smax + dx


def resolve_device(device=None) -> torch.device:
    """The device of a density: the card unless the caller names another;
    nothing falls back to the CPU because no card was found."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the density scatter-add runs on a CUDA device "
                           "and none is available; pass device='cpu' "
                           "(CLI: kinetics --device cpu) for the CPU")
    return device


def accumulate(positions: torch.Tensor, weights: torch.Tensor,
               mask: torch.Tensor, gmin: torch.Tensor, delta: torch.Tensor,
               nbins: Tuple[int, int, int],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter-add (F, A, 3) positions x (F, K) frame weights x (F, A)
    atom-slot mask into ``out``, a (K, nvox + 1) f32 buffer (fresh zeros
    when None), and return it.

    Voxels are ``floor((pos - gmin) / delta)``: an f32 subtract, an f32
    divide, then the floor, the JAX package's op order, so an atom on a
    voxel edge lands where it puts it. Atoms outside the grid (a negative
    or too-large index) go to column ``nvox``, the component's spill bin;
    padded slots (mask 0) add nothing anywhere."""
    K = weights.shape[1]
    nx, ny, nz = nbins
    nvox = nx * ny * nz
    if out is None:
        out = torch.zeros((K, nvox + 1), dtype=torch.float32,
                          device=positions.device)
    f = torch.floor((positions - gmin) / delta)                # (F, A, 3)
    valid = ((f >= 0).all(dim=-1) & (f[..., 0] < nx) & (f[..., 1] < ny)
             & (f[..., 2] < nz))
    idx = f.to(torch.int64)
    flat = idx[..., 0] * (ny * nz) + idx[..., 1] * nz + idx[..., 2]
    flat = torch.where(valid, flat, nvox)
    w = weights.T[:, :, None] * mask[None]                      # (K, F, A)
    out.index_add_(1, flat.reshape(-1), w.reshape(K, -1))
    return out


def accumulate_frames_sharded(positions, weights, mask, gmin, delta,
                              nbins: Tuple[int, int, int], mesh,
                              axis: str = "lanes",
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Frame-sharded :func:`accumulate` over the devices of ``mesh``'s
    ``axis`` (``parallel.mesh``): the (F, ...) host arrays are padded to
    the shard count with zero-mask rows, shard s's frames scatter into a
    (K, nvox + 1) buffer on its device, and the shards' buffers are summed
    into ``out`` (fresh zeros when None) on the first device, shard 0's
    buffer being ``out`` itself. Every shard is launched before any is
    summed. The sum's order differs from one scatter-add's, so the grids
    equal the unsharded ones to f32 rounding (rtol 1e-5 of a grid's
    largest value), not bit for bit."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    F = len(positions)
    pad = -F % n
    positions, weights, mask = (np.asarray(a, np.float32)
                                for a in (positions, weights, mask))
    if pad:
        positions = np.concatenate(
            [positions, np.repeat(positions[-1:], pad, axis=0)])
        weights = np.concatenate(
            [weights, np.zeros((pad,) + weights.shape[1:], np.float32)])
        mask = np.concatenate(
            [mask, np.zeros((pad,) + mask.shape[1:], np.float32)])
    per = (F + pad) // n
    K = weights.shape[1]
    nvox = int(np.prod(nbins))
    home = devices[0]
    if out is None:
        out = torch.zeros((K, nvox + 1), dtype=torch.float32, device=home)
    bufs = []
    for s, dev in enumerate(devices):
        sl = slice(s * per, (s + 1) * per)
        bufs.append(accumulate(
            _as_f32(positions[sl], dev), _as_f32(weights[sl], dev),
            _as_f32(mask[sl], dev), gmin.to(dev), delta.to(dev), nbins,
            out if s == 0 else None))
    for buf in bufs[1:]:
        out += buf.to(home)
    return out


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


class GridAccumulator:
    """Incremental weighted 3-D histogram over a fixed grid, on ``device``
    (default the card).

    Callers stream (positions, weights[, mask]) chunks without ever
    materialising the full position table (the frame table can be an
    on-disk memmap of GB scale). ``grids`` (a view of the device buffer)
    and ``_spilled`` (f64, the out-of-grid weight of each component) stay
    on the device across chunks; :meth:`finish` reads them back once.

    With a ``mesh`` (``parallel.mesh.make_mesh``) each chunk's frames are
    split over the devices of its ``mesh_axis``
    (:func:`accumulate_frames_sharded`) and the grids live on the axis'
    first device."""

    def __init__(self, K: int, gridcenter, xdim=40.0, ydim=40.0,
                 zdim=40.0, delta: float = 1.0, device=None, mesh=None,
                 mesh_axis: str = "lanes"):
        self._mesh, self._mesh_axis = mesh, mesh_axis
        if mesh is not None:
            device = mesh.axis_devices(mesh_axis)[0]
        self.device = resolve_device(device)
        center = np.asarray(gridcenter, np.float64)
        halfdim = np.asarray([xdim, ydim, zdim], np.float64) / 2
        nbins, gmin, gmax = fixedwidth_bins(delta, center - halfdim,
                                            center + halfdim)
        self.edges = [np.linspace(gmin[d], gmax[d], nbins[d] + 1)
                      for d in range(3)]
        self._nbins = tuple(int(n) for n in nbins)
        self._gmin = torch.tensor(gmin, dtype=torch.float32,
                                  device=self.device)
        self._delta = torch.tensor((gmax - gmin) / nbins,
                                   dtype=torch.float32, device=self.device)
        nvox = int(np.prod(self._nbins))
        self._buf = torch.zeros((K, nvox + 1), dtype=torch.float32,
                                device=self.device)
        self.grids = self._buf[:, :nvox].unflatten(1, self._nbins)
        self._spilled = torch.zeros(K, dtype=torch.float64,
                                    device=self.device)
        self.n_rows = 0

    def add(self, positions, weights, mask=None, frame_chunk: int = 256):
        """Accumulate (F, A, 3) positions with (F, K) or (F,) weights and
        an optional (F, A) live-atom mask, ``frame_chunk`` frames a
        scatter-add; numpy inputs are uploaded chunk by chunk."""
        n = len(positions)
        for lo in range(0, n, frame_chunk):
            sl = slice(lo, lo + frame_chunk)
            if self._mesh is not None:
                w = np.asarray(weights[sl], np.float32)
                m = (np.ones(np.shape(positions[sl])[:2], np.float32)
                     if mask is None else mask[sl])
                accumulate_frames_sharded(
                    positions[sl], w[:, None] if w.ndim == 1 else w, m,
                    self._gmin, self._delta, self._nbins, self._mesh,
                    self._mesh_axis, self._buf)
            else:
                pos = _as_f32(positions[sl], self.device)
                w = _as_f32(weights[sl], self.device)
                m = (torch.ones(pos.shape[:2], dtype=torch.float32,
                                device=self.device) if mask is None
                     else _as_f32(mask[sl], self.device))
                accumulate(pos, w[:, None] if w.dim() == 1 else w, m,
                           self._gmin, self._delta, self._nbins, self._buf)
            # the spill bin of each chunk is summed in f32 and carried in
            # f64, as the JAX package does
            self._spilled += self._buf[:, -1].double()
            self._buf[:, -1] = 0.0
        self.n_rows += n

    def finish(self):
        """Read the grids back, warn about out-of-grid loss; return
        (grids (K, nx, ny, nz) numpy, edges)."""
        grids = self.grids.to("cpu", copy=True).numpy()
        spilled = self._spilled.to("cpu", copy=True).numpy()
        total = (grids.reshape(len(grids), -1)
                 .sum(axis=-1, dtype=np.float64) + spilled)
        lost = spilled.sum()
        if lost > 0 and total.sum() > 0:
            warnings.warn(
                f"{lost / total.sum():.1%} of weighted density falls "
                "outside the grid and was dropped; enlarge the grid "
                "dimensions or recenter it (reference wdensity.py:206-218 "
                "contract)", stacklevel=2)
        return grids, self.edges


def weighted_histogram_3d(positions: np.ndarray, weights: np.ndarray,
                          gridcenter=None, xdim=40.0, ydim=40.0, zdim=40.0,
                          delta: float = 1.0, padding: float = 2.0,
                          frame_chunk: int = 256, mask=None, device=None):
    """Per-component weighted position histograms.

    Args:
        positions: (F, A, 3) atom coordinates [Angstrom].
        weights: (F, K) per-frame component weights.
        mask: optional (F, A) atom-slot mask (0 = padded slot).
        device: where the scatter-add runs (default the card).
    Returns:
        (grids (K, nx, ny, nz), edges [3 arrays]).
    """
    positions = np.asarray(positions, np.float32)
    weights = np.asarray(weights, np.float32)
    if weights.ndim == 1:
        weights = weights[:, None]
    if gridcenter is None:
        smin = positions.reshape(-1, 3).min(axis=0) - padding
        smax = positions.reshape(-1, 3).max(axis=0) + padding
        gridcenter = 0.5 * (smin + smax)
        xdim, ydim, zdim = smax - smin
    acc = GridAccumulator(weights.shape[1], gridcenter, xdim, ydim, zdim,
                          delta, device=device)
    acc.add(positions, weights, mask, frame_chunk)
    return acc.finish()


# number densities expressed in Angstrom^-3 per 1 unit of each density
# unit (reference wdensity.py:440-627 semantics: water-model units are the
# bulk number density of that water model at standard conditions,
# rho [g/cm^3] * N_A / MW / 1e24)
_N_AVOGADRO = 6.02214129e23
_MW_WATER = 18.016
_WATER_RHO = {"water": 0.997, "SPC": 0.985, "TIP3P": 1.002, "TIP4P": 1.001}
DENSITY_UNITS = {
    "Angstrom^{-3}": 1.0,
    "nm^{-3}": 1e-3,
    "Molar": _N_AVOGADRO / 1e27,
}
DENSITY_UNITS.update({
    name: rho * _N_AVOGADRO / _MW_WATER / 1e24
    for name, rho in _WATER_RHO.items()})

LENGTH_UNITS = {"Angstrom": 1.0, "nm": 10.0}  # Angstrom per 1 unit


@dataclasses.dataclass
class Density:
    """A scalar grid with histogram->density conversion, unit conversion,
    and DX export (the retained surface of the reference's vendored Density
    class, wdensity.py:361-627)."""
    grid: np.ndarray
    edges: list
    is_density: bool = False
    length_unit: str = "Angstrom"
    density_unit: Optional[str] = None   # None until make_density

    @property
    def delta(self) -> np.ndarray:
        return np.asarray([e[1] - e[0] for e in self.edges])

    @property
    def origin(self) -> np.ndarray:
        return np.asarray([0.5 * (e[0] + e[1]) for e in self.edges])

    def make_density(self) -> "Density":
        """Counts -> counts/volume (reference wdensity.py:528-552)."""
        if self.is_density:
            return self
        self.grid = self.grid / np.prod(self.delta)
        self.is_density = True
        self.density_unit = ("Angstrom^{-3}" if self.length_unit ==
                             "Angstrom" else "nm^{-3}")
        return self

    def convert_density(self, unit: str = "Angstrom^{-3}") -> "Density":
        """Re-express the density in another unit (reference
        wdensity.py:575-608): absolute units, or relative to the bulk
        number density of a water model ('water', 'SPC', 'TIP3P', 'TIP4P';
        a value of 1.0 then means bulk-water density)."""
        if not self.is_density:
            raise RuntimeError("call make_density() before convert_density")
        if unit not in DENSITY_UNITS:
            raise ValueError(f"unknown density unit {unit!r}; one of "
                             f"{sorted(DENSITY_UNITS)}")
        self.grid = self.grid * (DENSITY_UNITS[self.density_unit]
                                 / DENSITY_UNITS[unit])
        self.density_unit = unit
        return self

    def convert_length(self, unit: str = "Angstrom") -> "Density":
        """Convert the grid axes (edges/origin/delta) between length units
        (reference wdensity.py:554-573). Densities keep their unit; call
        convert_density to re-express values."""
        if unit not in LENGTH_UNITS:
            raise ValueError(f"unknown length unit {unit!r}; one of "
                             f"{sorted(LENGTH_UNITS)}")
        factor = LENGTH_UNITS[self.length_unit] / LENGTH_UNITS[unit]
        self.edges = [e * factor for e in self.edges]
        self.length_unit = unit
        return self

    def export(self, path: str) -> str:
        return write_dx(path, self.grid, self.origin, self.delta)


class WDensity:
    """Weighted density analysis over a frame set.

    One pass produces all component densities (the reference needs the
    pwdensity fork for that, pwdensity.py:254-280); pass a (F,) weight
    vector for the single-density wdensity variant.
    """

    def __init__(self, positions: np.ndarray, weights: np.ndarray,
                 gridcenter=None, xdim=40.0, ydim=40.0, zdim=40.0,
                 delta: float = 1.0, padding: float = 2.0, mask=None,
                 device=None):
        grids, edges = weighted_histogram_3d(
            positions, weights, gridcenter, xdim, ydim, zdim, delta,
            padding, mask=mask, device=device)
        grids = grids / float(len(positions))   # reference wdensity.py:268
        self.densities = [Density(g, edges).make_density() for g in grids]

    @classmethod
    def from_accumulator(cls, acc: GridAccumulator) -> "WDensity":
        """Finish a streamed :class:`GridAccumulator` into densities
        without ever holding the full position table (memmapped frame
        tables; reference kinetics.py:46-77 scale)."""
        grids, edges = acc.finish()
        grids = grids / float(max(acc.n_rows, 1))
        self = cls.__new__(cls)
        self.densities = [Density(g, edges).make_density() for g in grids]
        return self

    @property
    def density(self) -> Density:
        return self.densities[0]
