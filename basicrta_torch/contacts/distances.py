"""Batched per-residue-pair minimum-distance kernel (plain torch ops).

Port of ``basicrta_tpu.contacts.distances``, which replaces the
reference's per-frame ``MDAnalysis.lib.distances.capped_distance`` C
neighbour search + Counter reduction (reference contacts.py:112-127):
atoms are grouped by residue (padded to the widest residue), a frame batch
of coordinates is streamed to the device, and a chunked broadcast-subtract /
min-reduce produces the (frame, R1, R2) matrix of minimum atomic distances
under the minimum-image convention. Semantics: 'any atom within cutoff,
record the pair's minimum distance'.

The JAX package's version is ``jax.numpy`` under ``jax.jit``, which fuses
the pairwise broadcast; eager torch materialises every elementwise result.
So the displacement is kept as three per-axis planes (no trailing axis of
3), updated in place, and the chunk of the R1 (or pair) axis is taken from
a byte budget. Each (frame, residue pair) is computed from its own atoms
only, so the result does not depend on the chunk, bit for bit.

Every function runs on the device its tensors lie on.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

# bytes one pairwise temporary may take; the kernels keep 4-5 of them alive
# (8 at half the size under a triclinic box)
CHUNK_BYTES = 256 * 2 ** 20


def group_by_residue(resids: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Group atoms into (R, P) padded residue index blocks.

    Returns the per-residue atom-index matrix (R, P) with -1 padding and the
    sorted unique resids (R,). Atoms of a residue keep their order.
    """
    uniq, inverse = np.unique(resids, return_inverse=True)
    counts = np.bincount(inverse)
    R, P = len(uniq), int(counts.max())
    idx = np.full((R, P), -1, dtype=np.int64)
    order = np.argsort(inverse, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(order)) - np.repeat(starts, counts)
    idx[inverse[order], slot] = order
    return idx, uniq


def gather_grouped(positions: torch.Tensor, idx: np.ndarray):
    """(..., A, 3) positions -> ((..., R, P, 3), (R, P) validity mask).

    Padding slots point at atom 0 (harmless coordinates); the mask excludes
    them from distance minima. A coordinate sentinel would be wrapped back
    into the box by the minimum-image convention, so masking is the only
    correct padding under PBC.
    """
    take = torch.as_tensor(np.where(idx < 0, 0, idx),
                           device=positions.device)
    return (positions[..., take, :],
            torch.as_tensor(idx >= 0, device=positions.device))


def _lead(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-frame (F,) quantity shaped to broadcast over ``ndim`` axes."""
    return x.reshape((-1,) + (1,) * (ndim - 1))


def _min_image_d2(d: List[torch.Tensor], box, use_pbc: bool,
                  triclinic: bool) -> torch.Tensor:
    """Squared norms of displacement vectors under the minimum-image
    convention. ``d``: the x, y and z planes of the displacements, each
    (F, ...), fresh tensors that are overwritten; ``box``: (F, 3) lengths
    or (F, 3, 3) reduced matrix.

    Orthorhombic: one per-axis round. Triclinic: staircase reduction over
    the lower-triangular lattice rows, then an exact 27-image search
    (reference semantics: MDAnalysis capped_distance on triclinic
    dimensions, contacts.py:115-117).
    """
    nd = d[0].ndim
    if use_pbc and triclinic:
        H = box                                    # (F, 3, 3)
        for i in (2, 1, 0):
            n = (d[i] / _lead(H[:, i, i], nd)).round_()
            for k in range(3):
                d[k] -= _lead(H[:, i, k], nd) * n
        d2 = torch.full_like(d[0], float("inf"))
        for sa in (-1, 0, 1):
            for sb in (-1, 0, 1):
                for sc in (-1, 0, 1):
                    s = sa * H[:, 0] + sb * H[:, 1] + sc * H[:, 2]  # (F, 3)
                    acc = None
                    for k in range(3):
                        dd = d[k] + _lead(s[:, k], nd)
                        dd *= dd
                        acc = dd if acc is None else acc.add_(dd)
                    torch.minimum(d2, acc, out=d2)
        return d2
    acc = None
    for k in range(3):
        dk = d[k]
        if use_pbc:
            b = _lead(box[:, k], nd)
            dk -= (dk / b).round_().mul_(b)
        dk *= dk
        acc = dk if acc is None else acc.add_(dk)
    return acc


def _budget_chunk(per_item_bytes: int, n_items: int) -> int:
    return int(max(1, min(n_items, CHUNK_BYTES // max(per_item_bytes, 1))))


def min_dist_per_residue_pair(pos1: torch.Tensor, pos2: torch.Tensor,
                              box: Optional[torch.Tensor] = None,
                              chunk: Optional[int] = None,
                              use_pbc: bool = True,
                              mask1: Optional[torch.Tensor] = None,
                              mask2: Optional[torch.Tensor] = None,
                              triclinic: bool = False) -> torch.Tensor:
    """Minimum atomic distance for every residue pair in a frame batch.

    Args:
        pos1: (F, R1, P1, 3) grouped coordinates of group 1 [A].
        pos2: (F, R2, P2, 3) grouped coordinates of group 2 [A].
        box: (F, 3) orthorhombic box lengths, or, with ``triclinic``, the
            (F, 3, 3) GROMACS-reduced box matrix (rows are the lattice
            vectors; a = (ax,0,0), b = (bx,by,0), c = (cx,cy,cz)) [A];
            required when use_pbc.
        chunk: R1-axis chunk size bounding transient memory; None takes it
            from ``CHUNK_BYTES``. The result does not depend on it.
        use_pbc: apply the minimum-image convention.
        mask1/mask2: (R1, P1)/(R2, P2) validity masks for padded atom
            slots; None means every slot is an atom.
        triclinic: general minimum image (staircase reduction + 27-image
            search, exact for GROMACS-reduced boxes).

    Returns:
        (F, R1, R2) float32 minimum distances.
    """
    F, R1, P1, _ = pos1.shape
    _, R2, P2, _ = pos2.shape
    if chunk is None:
        chunk = _budget_chunk(4 * F * P1 * R2 * P2 * (1 + triclinic), R1)
    out = torch.empty((F, R1, R2), dtype=torch.float32, device=pos1.device)
    for lo in range(0, R1, chunk):
        p1 = pos1[:, lo:lo + chunk]                # (F, c, P1, 3)
        d = [p1[:, :, :, None, None, k] - pos2[:, None, None, :, :, k]
             for k in range(3)]                    # (F, c, P1, R2, P2)
        d2 = _min_image_d2(d, box, use_pbc, triclinic)
        if mask1 is not None:
            d2.masked_fill_(~mask1[None, lo:lo + chunk, :, None, None],
                            float("inf"))
        if mask2 is not None:
            d2.masked_fill_(~mask2[None, None, None, :, :], float("inf"))
        out[:, lo:lo + chunk] = d2.amin(dim=(2, 4))
    return out.sqrt_()


def compact_contacts(dmin: torch.Tensor, cutoff: float, cap: int):
    """Device-side sparsification of the dense (F, R1, R2) distance batch.

    Contacts are sparse (tens to hundreds of sub-cutoff pairs per frame out
    of R1*R2), so only they need cross to the host. ``topk`` on the
    hit-masked negated distances packs every sub-cutoff entry (exact f32
    values) into a fixed (F, cap) buffer. The order of tied entries (the
    -inf pads) is unspecified: compare row sets, not raw buffers.

    Returns:
        (n_hits (F,) int32, flat_idx (F, cap) int32 into R1*R2,
        dist (F, cap) f32; slots beyond a frame's hits carry +inf).
        A frame with ``n_hits > cap`` overflowed: the caller must fall
        back to the dense transfer for that batch (exactness guard).
    """
    flat = dmin.reshape(dmin.shape[0], -1)
    hit = flat <= cutoff
    n = hit.sum(dim=-1, dtype=torch.int32)
    score = torch.where(hit, -flat, float("-inf"))
    vals, idx = torch.topk(score, min(cap, flat.shape[1]), dim=-1)
    return n, idx.to(torch.int32), -vals


def _centroid_rad(pos: torch.Tensor, mask: Optional[torch.Tensor]):
    """Masked centroid (F, R, 3) and free-space bounding radius (F, R) per
    (frame, residue)."""
    if mask is None:
        c = pos.sum(dim=2) / pos.shape[2]
        d2 = ((pos - c[:, :, None, :]) ** 2).sum(dim=-1)
    else:
        m = mask[None, :, :, None].to(pos.dtype)
        n = mask.sum(dim=-1).clamp(min=1)[None, :, None]
        c = (pos * m).sum(dim=2) / n
        d2 = ((pos - c[:, :, None, :]) ** 2).sum(dim=-1)
        d2 = torch.where(mask[None], d2, 0.0)
    return c, d2.amax(dim=-1).sqrt_()


def min_dist_pruned(pos1: torch.Tensor, pos2: torch.Tensor,
                    cutoff: float, box: Optional[torch.Tensor] = None,
                    cap_pairs: int = 4096, chunk: Optional[int] = None,
                    use_pbc: bool = True,
                    mask1: Optional[torch.Tensor] = None,
                    mask2: Optional[torch.Tensor] = None,
                    triclinic: bool = False):
    """Bounding-sphere-pruned minimum distances: exact sub-cutoff contacts
    at a fraction of the dense kernel's work.

    The dense kernel visits all R1*P1*R2*P2 atom pairs per frame. Here a
    coarse stage computes per-residue centroids and bounding radii,
    O(R1*P1 + R2*P2), and a centroid distance matrix, O(R1*R2), giving the
    lower bound ``min_atom_dist >= d_centroid - rad1 - rad2`` (triangle
    inequality; it holds under PBC because the torus metric is a metric and
    the free-space radius bounds the torus radius). Only pairs whose bound
    reaches the cutoff get the exact P1*P2 atom sweep, packed into a fixed
    (F, cap_pairs) buffer.

    Returns:
        (n_plausible (F,) int32, flat_idx (F, cap_pairs) int32 into R1*R2,
        dist (F, cap_pairs) f32; +inf beyond a frame's plausible pairs).
        A frame with ``n_plausible > cap_pairs`` overflowed: the caller
        must fall back to the dense kernel for that batch (exactness
        guard: dropped pairs are only ever provably beyond the cutoff).
    """
    F, R1, P1, _ = pos1.shape
    _, R2, P2, _ = pos2.shape
    c1, rad1 = _centroid_rad(pos1, mask1)
    c2, rad2 = _centroid_rad(pos2, mask2)
    dc = [c1[:, :, None, k] - c2[:, None, :, k] for k in range(3)]
    lb = _min_image_d2(dc, box, use_pbc, triclinic).sqrt_()   # (F, R1, R2)
    lb -= rad1[:, :, None]
    lb -= rad2[:, None, :]
    plausible = (lb <= cutoff).reshape(F, -1)
    n_pl = plausible.sum(dim=-1, dtype=torch.int32)
    score = torch.where(plausible, -lb.reshape(F, -1), float("-inf"))
    top, flat_idx = torch.topk(score, min(cap_pairs, R1 * R2), dim=-1)
    dead = ~torch.isfinite(top)                                # (F, cap)

    cap = flat_idx.shape[1]
    if chunk is None:
        chunk = _budget_chunk(4 * F * P1 * P2 * (1 + triclinic), cap)
    frame = torch.arange(F, device=pos1.device)[:, None]
    d2min = torch.empty((F, cap), dtype=torch.float32, device=pos1.device)
    for lo in range(0, cap, chunk):
        idx = flat_idx[:, lo:lo + chunk]                       # (F, c)
        i = idx // R2
        j = idx % R2
        g1 = pos1[frame, i]                                    # (F, c, P1, 3)
        g2 = pos2[frame, j]
        d = [g1[:, :, :, None, k] - g2[:, :, None, :, k] for k in range(3)]
        d2 = _min_image_d2(d, box, use_pbc, triclinic)         # (F, c, P1, P2)
        if mask1 is not None:
            d2.masked_fill_(~mask1[i][:, :, :, None], float("inf"))
        if mask2 is not None:
            d2.masked_fill_(~mask2[j][:, :, None, :], float("inf"))
        d2min[:, lo:lo + chunk] = d2.amin(dim=(2, 3))
    d2min.masked_fill_(dead, float("inf"))
    return n_pl, flat_idx.to(torch.int32), d2min.sqrt_()


def contacts_from_batch(min_dists: np.ndarray, frame_ids: np.ndarray,
                        frame_times: np.ndarray, resids1: np.ndarray,
                        resids2: np.ndarray, cutoff: float):
    """Extract sparse contact rows from a dense (F, R1, R2) distance batch.

    Returns column arrays (frames, sel1_resids, sel2_resids, min_dist,
    times) for rows with distance <= cutoff: the schema of the reference's
    shard rows (contacts.py:125-127).
    """
    f, i, j = np.nonzero(min_dists <= cutoff)
    return (frame_ids[f].astype(np.int64),
            resids1[i].astype(np.int32),
            resids2[j].astype(np.int32),
            min_dists[f, i, j].astype(np.float32),
            frame_times[f].astype(np.float64))
