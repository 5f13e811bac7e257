"""u16 wire format of the coordinate upload (MapContacts).

Per-frame affine quantization onto the 16-bit grid spanning each axis's
coordinate extent: half the upload bytes for a coordinate error
<= extent/65535/2 (~0.002 A for a 240 A box; XTC itself stores a 0.01 A
grid, so such trajectories carry no finer information). The affine offset
preserves atom locality: wrapping into [0, box) instead would split
boundary-straddling residues and blow their bounding spheres up to box
scale, silently defeating the pruned kernel. Geometry-independent:
orthorhombic, triclinic, or no box. Bit for bit the JAX package's
quantizer.
"""
from __future__ import annotations

import numpy as np

__all__ = ["quantize_u16"]

_BLOCK = 64   # atoms folded into one row of the blocked reduction


def _over_atoms(op, x: np.ndarray) -> np.ndarray:
    """``op.reduce(x, axis=1, keepdims=True)`` of an (F, A, 3) array, for
    ``op`` np.minimum or np.maximum: exact whatever the order, so the atoms
    are folded ``_BLOCK`` to a row first. numpy reduces a long axis over an
    inner axis of 3 without vector code; over rows of 192 it does."""
    F, A, _ = x.shape
    c = A // _BLOCK * _BLOCK
    if c == 0 or not x.flags.c_contiguous:
        return op.reduce(x, axis=1, keepdims=True)
    m = op.reduce(x[:, :c].reshape(F, c // _BLOCK, 3 * _BLOCK), axis=1)
    m = op.reduce(m.reshape(F, _BLOCK, 3), axis=1)
    if c < A:
        m = op(m, op.reduce(x[:, c:], axis=1))
    return m[:, None, :]


def quantize_u16(positions: np.ndarray):
    """Quantize ``(F, A, 3)`` coordinates to the per-frame u16 grid.

    Returns ``(q, scale)``: ``q`` is ``(F, A, 3) uint16``, ``scale`` is
    ``(F, 2, 3) float32`` with row 0 the grid step and row 1 the frame
    offset ``lo`` — the device dequant is ``q * step + lo``.

    The grid mapping runs in the SHIFTED domain,
    ``(positions - lo) * inv + 0.5`` — not the fused absolute-coordinate
    form ``positions * inv + (0.5 - lo * inv)``, whose float32 rounding
    scales with ``|lo| / extent`` and can reach 65536.0 (a wrapping,
    silently full-extent-wrong uint16 cast, and C-UB for the negative
    values the fused form can also produce) once coordinates sit
    thousands of Angstroms from the origin with a small axis extent —
    exactly the unwrapped/drifted trajectories the affine offset exists
    to support. Shifted-domain bound, independent of ``|lo|``: the
    subtraction is exact and >= 0 elementwise (``lo`` is the elementwise
    min), ``fl(shifted) * fl(1/step) <= 65535 * (1 + ~4 eps) < 65535.04``,
    plus 0.5 rounds to at most ~65535.6 < 65536, so the truncating cast
    can neither wrap nor go negative (tests:
    test_u16_extremes_never_wrap, test_u16_far_from_origin_never_wraps).

    Three elementwise passes + the cast, on the host.
    """
    lo = _over_atoms(np.minimum, positions)             # (F, 1, 3)
    shifted = (positions - lo).astype(np.float32, copy=False)  # >= 0 exact
    ext = _over_atoms(np.maximum, shifted)
    step = np.maximum(ext / 65535.0, 1e-12).astype(np.float32)
    inv = (1.0 / step).astype(np.float32)
    # round-half-up via +0.5 and the truncating cast (vs rint's
    # ties-to-even: half a grid step, below the format's error bound).
    # In-place on the shifted temp: the (F, A, 3) buffers are tens of MB
    # at bilayer scale, so two allocations in all instead of one per
    # elementwise op
    np.multiply(shifted, inv, out=shifted)
    np.add(shifted, np.float32(0.5), out=shifted)
    q = shifted.astype(np.uint16)
    scale = np.concatenate([step, lo.astype(np.float32)], axis=1)
    return q, scale
