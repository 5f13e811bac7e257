"""Batched multi-residue Gibbs sampling.

Port of ``basicrta_tpu.sampler.batch``: every residue (x every chain) is
one lane of a bucket, and each host-level segment of ``segment_blocks``
thinning blocks is one launch of the fused sweep kernel. Two layouts:

- the production layout (``ladder=None``, the JAX package's default for
  its fused engine): a cost-model DP over the V-sorted residues, adjacent
  buckets merged under k-way mixed-width packing, so up to 12 residues
  share one 128-column physical lane (K3,
  :func:`basicrta_torch.sampler.cuda_sweep.segment_packed`) and large
  residues run unpacked (K2, :func:`~basicrta_torch.sampler.cuda_sweep.
  segment`);
- the coarse power-of-two ladder (``ladder='pow2'``), unpacked.

The layout code is pure numpy and a line-for-line port, including the
cost constants fitted on the TPU, so both packages lay a protein out into
the same buckets. Segments checkpoint and resume exactly, because the
kernels reseed every sweep from the absolute sweep index; for the same
reason :func:`run_residues` can keep every bucket on the card at once, each
on a CUDA stream of its own, and still return each bucket's own chain.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler.cuda_sweep import (pad_tiers_to_rows,
                                               packed_row_tiers, segment,
                                               segment_packed,
                                               segment_packed_torch,
                                               segment_torch)
from basicrta_torch.sampler.kernels import (SMALL_NMAX, MixtureState,
                                            compute_tiers, dedup_times,
                                            init_mixture_params)

ENGINES = ("cuda", "torch")


def _next_pow2(n: int, floor: int = 128, step: int = 2) -> int:
    """Smallest floor * step^k >= n."""
    b = floor
    while b < n:
        b *= step
    return b


@dataclasses.dataclass
class ResidueBatch:
    """A padded, stacked bucket of residues; value columns are sorted by
    multiplicity descending per lane, padding has count 0 and value 1.

    ``pack > 1`` marks a packed bucket: ``pack`` logical lanes share one
    128-column physical lane. With ``bounds`` None the split is uniform
    (each lane owns 128 // pack columns of every row); otherwise
    ``bounds`` is the (Bph, pack) per-slot column widths of the k-way
    mixed layout (0 = empty slot), members stored lane-major in slot
    order, each owning its slot's columns of all ``phys_rows`` rows."""
    names: List[str]               # residue labels, length B
    values: np.ndarray             # (B, V) unique residence times
    counts: np.ndarray             # (B, V) multiplicities, 0 marks padding
    n_events: np.ndarray           # (B,) true event count per residue
    tiers: Tuple[int, int] = (0, 0)  # column tier boundaries
    pack: int = 1                  # logical lanes per physical lane
    bounds: Optional[np.ndarray] = None  # (Bph, pack) mixed slot widths
    phys_rows: int = 0             # rows per physical lane (mixed only)

    @property
    def size(self) -> int:
        return len(self.names)


# packed segment widths: V <= 16/32 shares a physical lane 8/4-up; larger
# residues pair into 64-column segments
_PACK_WIDTHS = (16, 32)
_PACK2_W = 64


def _pack_choice(V: int):
    """(width, pack) of the raw fine ladder (``consolidate=False``)."""
    for w in _PACK_WIDTHS:
        if V <= w:
            return (w, 128 // w)
    r = -(-V // _PACK2_W)
    if r == 1 or r % 2 == 1:
        return (_PACK2_W * r, 2)
    return (-(-V // 128) * 128, 1)


# The JAX package's per-sweep cost model [us/sweep], fitted on a TPU v5e
# (basicrta_tpu/sampler/batch.py). Kept as they are so that both packages
# lay a protein out into the same buckets; a fit on the H100 is separate,
# measured work.
_COST_PER_BUCKET = 3.8      # per-call overhead / segment length
_COST_ROW = 0.020           # per padded physical row (floor)
_COST_HEAD_PREM = 0.635     # per head-tier row x lane
_COST_SMALL_PREM = 0.109    # per small-tier row x lane
_COST_LANE_LOG = 0.120      # per logical lane (conjugate draw)


def _phys_groups(Bph: int, SL: int, pack: int) -> Tuple[int, int]:
    """(NG, G) lane groups of a bucket of Bph physical lanes at the
    production K = 15, n_blocks = 100 (the kernel's group layout)."""
    K_nom, nb_nom = 15, 100
    per_lane = (K_nom + 12) * SL * 128 * 4 + 2 * nb_nom * pack * K_nom * 4
    g_fit = max(8, ((12 * 2 ** 20) // per_lane) // 8 * 8)
    cap = min(64, g_fit)
    NG = -(-Bph // cap)
    G = max(8, (-(-Bph // NG) + 7) // 8 * 8)
    return NG, G


def _cost_terms(Bph: int, SL: int, head: int, small: int,
                pack: int) -> float:
    """Modelled us/sweep of a bucket's physical layout: a per-group
    constant plus per-row terms over the padded lane count."""
    NG, G = _phys_groups(Bph, SL, pack)
    lanes = NG * G
    return (_COST_PER_BUCKET * NG
            + lanes * SL * _COST_ROW
            + lanes * head * _COST_HEAD_PREM
            + lanes * (small - head) * _COST_SMALL_PREM
            + lanes * pack * _COST_LANE_LOG)


def _layout_cost(B: int, width: int, pack: int, head_end: int,
                 single_start: int) -> float:
    """Modelled us/sweep of one bucket of B lanes whose worst member has
    ``head_end`` head-tier and ``single_start`` multi-count columns."""
    seg_w = 128 // pack if pack > 1 else 128
    SL = max(1, width // seg_w)
    head = min(-(-head_end // seg_w), SL)
    small = min(max(-(-single_start // seg_w), head), SL)
    return _cost_terms(-(-B // pack), SL, head, small, pack)


def _bucket_cost(members, width: int, pack: int) -> float:
    """_layout_cost of a concrete member list."""
    if not members:
        return 0.0
    head_end = max(int(np.sum(c > SMALL_NMAX)) for _, _, c in members)
    single_start = max(int(np.sum(c > 1)) for _, _, c in members)
    return _layout_cost(len(members), width, pack, head_end, single_start)


def modeled_work_waste(batches: Sequence["ResidueBatch"]) -> float:
    """Fraction of modelled per-sweep kernel work spent on padding under
    the cost model's row terms (the per-group constant excluded)."""
    padded = live = 0.0
    for b in batches:
        if b.bounds is not None:
            Bph, SL = len(b.bounds), b.phys_rows
            cost = _mixed_cost([(None, None, c) for c in b.counts],
                               b.bounds, b.phys_rows)
        else:
            Bph = -(-b.size // b.pack)
            seg_w = 128 // b.pack if b.pack > 1 else 128
            SL = max(1, b.values.shape[1] // seg_w)
            head_end = int(max((np.sum(c > SMALL_NMAX) for c in b.counts),
                               default=0))
            single_start = int(max((np.sum(c > 1) for c in b.counts),
                                   default=0))
            cost = _layout_cost(b.size, b.values.shape[1], b.pack,
                                head_end, single_start)
        padded += cost - _COST_PER_BUCKET * _phys_groups(Bph, SL,
                                                         b.pack)[0]
        for c in b.counts:
            n_head = float(np.sum(c > SMALL_NMAX))
            n_multi = float(np.sum(c > 1))
            n_live = float(np.sum(c > 0))
            live += (n_live * _COST_ROW
                     + n_head * _COST_HEAD_PREM
                     + (n_multi - n_head) * _COST_SMALL_PREM) / 128.0
            live += _COST_LANE_LOG
    return 1.0 - live / padded if padded > 0 else 0.0


def _mixed_kpack(group, kmax: int = 12):
    """Mixed-width k-way layout of one bucket: best-fit-decreasing
    bin-packing of members into 128-column physical lanes (member i owns
    ceil(V_i / SL) columns of all SL rows, at most ``kmax`` members a
    lane), the cost model choosing among the candidate (SL, k).

    Returns (ordered_members, widths, SL): members lane-major in slot
    order, widths (Bph, pack) per-slot column widths (0 = empty slot),
    SL physical rows per lane."""
    Vs = [len(v) for _, v, _ in group]
    Vmax = max(Vs)
    min_sl = max(1, -(-Vmax // 128))
    cand_sl = sorted(set(list(range(min_sl, 3 * min_sl + 1))
                         + [(min_sl * f) // 2 for f in (7, 8)]))
    order = sorted(range(len(group)), key=lambda i: -Vs[i])
    best = None
    for SL in cand_sl:
        ws = [-(-V // SL) for V in Vs]
        if max(ws) > 128:
            continue
        for k in range(2, kmax + 1):
            lanes = []                     # [free_cols, [member_idx, ...]]
            for i in order:
                w = ws[i]
                fit = None
                for L in lanes:
                    if L[0] >= w and len(L[1]) < k and (
                            fit is None or L[0] < fit[0]):
                        fit = L            # best (tightest) fit
                if fit is None:
                    lanes.append([128 - w, [i]])
                else:
                    fit[0] -= w
                    fit[1].append(i)
            pack = max(len(L[1]) for L in lanes)
            if pack < 2:
                continue
            widths = np.zeros((len(lanes), pack), np.int64)
            members = []
            for g, (_, idxs) in enumerate(lanes):
                for s, i in enumerate(idxs):
                    members.append(group[i])
                    widths[g, s] = ws[i]
            cost = _mixed_cost(members, widths, SL)
            if best is None or cost < best[0]:
                best = (cost, members, widths, SL)
    if best is None:                       # single member or none fit
        m = group[0]
        return [m], np.asarray([[128]], np.int64), -(-len(m[1]) // 128)
    return best[1], best[2], best[3]


def _mixed_cost(members, widths: np.ndarray, SL: int) -> float:
    """Modelled us/sweep of a mixed-width k-way bucket: member i's head
    and multi-count columns occupy the first ceil(H_i / w_i) rows of its
    own segment."""
    ws = widths[widths > 0]       # row-major nonzero == member order
    head = small = 0
    for (name, v, c), w in zip(members, ws):
        H = int(np.sum(c > SMALL_NMAX))
        S1 = int(np.sum(c > 1))
        head = max(head, -(-H // int(w)))
        small = max(small, -(-S1 // int(w)))
    small = min(max(small, head), SL)
    head = min(head, SL)
    return _cost_terms(len(widths), SL, head, small, widths.shape[1])


def _pack_mixed(values_np: np.ndarray, counts_np: np.ndarray,
                widths: np.ndarray, SL: int):
    """Host-side physical packing of a mixed-width k-way bucket.

    values/counts: (B, V) members, lane-major in slot order; widths:
    (Bph, pack) per-slot column widths, 0 marking empty slots. Returns
    (v_ph, c_ph, seg_id, slot_idx): physical (Bph, SL, 128) rows, the
    (Bph, 128) f32 owning-slot tile (columns owned by no member carry
    slot 0 and count 0), and each member's slot index g * pack + s."""
    Bph, pack = widths.shape
    B, V = values_np.shape
    v_ph = np.ones((Bph, SL, 128), np.float32)
    c_ph = np.zeros((Bph, SL, 128), np.float32)
    seg_id = np.zeros((Bph, 128), np.float32)
    slot_idx = []
    i = 0
    for g in range(Bph):
        off = 0
        for s in range(pack):
            w = int(widths[g, s])
            if w == 0:
                continue
            if i >= B:
                raise ValueError("mixed-pack underflow: widths name more "
                                 f"slots than the {B} members provided")
            cap = SL * w
            n = min(cap, V)
            if counts_np[i, cap:].any():
                raise ValueError(
                    f"mixed-pack overflow: member {i} has live columns "
                    f"beyond its segment capacity {cap} (SL={SL}, "
                    f"width={w})")
            va = np.ones((cap,), np.float32)
            ca = np.zeros((cap,), np.float32)
            va[:n] = values_np[i, :n]
            ca[:n] = counts_np[i, :n]
            v_ph[g, :, off:off + w] = va.reshape(SL, w)
            c_ph[g, :, off:off + w] = ca.reshape(SL, w)
            seg_id[g, off:off + w] = s
            slot_idx.append(g * pack + s)
            off += w
            i += 1
    if i != B:
        raise ValueError(f"mixed-pack underflow: {B} members but widths "
                         f"name only {i} slots")
    return v_ph, c_ph, seg_id, np.asarray(slot_idx, np.int64)


def _mixed_row_tiers(c_ph: np.ndarray) -> Tuple[int, int]:
    """Physical-row tiers of a mixed-packed bucket: each segment is
    multiplicity-sorted row-major, so per-row maxima never increase."""
    rowmax = c_ph.max(axis=(0, 2)) if c_ph.size else np.zeros((0,))
    head = int((rowmax > SMALL_NMAX).sum())
    small = max(int((rowmax > 1).sum()), head)
    return head, small


def _dp_configs(Vm: int):
    """Every (width, pack) class that fits a bucket whose largest member
    has Vm live columns."""
    out = []
    for w in _PACK_WIDTHS:
        if Vm <= w:
            out.append((w, 128 // w))
    out.append((_PACK2_W * -(-Vm // _PACK2_W), 2))
    out.append((-(-Vm // 128) * 128, 1))
    return out


def _dp_layout(items) -> List[Tuple[Tuple[int, int], list]]:
    """Minimum-cost contiguous partition of the V-sorted residue list
    under :func:`_layout_cost`, every :func:`_dp_configs` class a
    candidate for each bucket. Returns [((width, pack), members), ...]."""
    items = sorted(items, key=lambda it: len(it[1]))
    n = len(items)
    H = [int(np.sum(c > SMALL_NMAX)) for _, _, c in items]
    S1 = [int(np.sum(c > 1)) for _, _, c in items]
    dp = [0.0] + [float("inf")] * n    # dp[j]: min cost of items[:j]
    cut = [0] * (n + 1)
    cfg = [None] * (n + 1)
    for j in range(1, n + 1):
        Vm = len(items[j - 1][1])
        hmax = smax = 0
        for i in range(j - 1, -1, -1):
            hmax = max(hmax, H[i])
            smax = max(smax, S1[i])
            best, bkey = float("inf"), None
            for (w, p) in _dp_configs(Vm):
                c = _layout_cost(j - i, w, p, hmax, smax)
                if c < best:
                    best, bkey = c, (w, p)
            tot = dp[i] + best
            if tot < dp[j]:
                dp[j], cut[j], cfg[j] = tot, i, bkey
    groups = []
    j = n
    while j > 0:
        i = cut[j]
        groups.append((cfg[j], items[i:j]))
        j = i
    groups.reverse()
    return groups


def _kpack_or_uniform_cost(key, group, kmax: int = 12) -> float:
    """Modelled cost of a bucket under the cheaper of its uniform class
    and the k-way mixed packing."""
    c = _bucket_cost(group, key[0], key[1])
    if len(group) > 1:
        m, w, sl = _mixed_kpack(group, kmax=kmax)
        c = min(c, _mixed_cost(m, w, sl))
    return c


def _merge_adjacent(groups, kmax: int = 12):
    """Greedy merge of adjacent DP buckets while the merged k-way layout
    models cheaper than the pair."""
    groups = list(groups)
    costs = [_kpack_or_uniform_cost(k, g, kmax) for k, g in groups]
    while len(groups) > 1:
        best = None
        for i in range(len(groups) - 1):
            merged = groups[i][1] + groups[i + 1][1]
            Vm = max(len(v) for _, v, _ in merged)
            key = (-(-Vm // 128) * 128, 1)
            c = _kpack_or_uniform_cost(key, merged, kmax)
            gain = costs[i] + costs[i + 1] - c
            if gain > 1e-9 and (best is None or gain > best[0]):
                best = (gain, i, key, merged, c)
        if best is None:
            break
        _, i, key, merged, c = best
        groups[i:i + 2] = [(key, merged)]
        costs[i:i + 2] = [c]
    return groups


def bucket_residues(times_per_residue: Dict[str, np.ndarray],
                    floor: Optional[int] = None,
                    pack_small: bool = True,
                    ladder: Optional[str] = None,
                    consolidate: bool = True,
                    mixed_pack: bool = True,
                    kmax: int = 12) -> List[ResidueBatch]:
    """Group residues into buckets (``basicrta_tpu`` ``bucket_residues``).

    The default is the production layout: :func:`_dp_layout`, then
    :func:`_merge_adjacent` and, per bucket, the k-way mixed packing where
    the cost model prefers it. ``ladder='pow2'`` gives the coarse
    power-of-two unpacked layout (V the smallest ``floor * 2^k``, floor
    128); an explicit ``floor`` keeps a single-class unpacked layout;
    ``consolidate=False`` gives the raw fine ladder of
    :func:`_pack_choice`."""
    items = []
    for name, t in times_per_residue.items():
        if len(t) == 0:
            continue
        v, c = dedup_times(t)
        items.append((name, v, c))
    packing = pack_small and floor is None and ladder != "pow2"
    if floor is None:
        floor = 128
    if packing and consolidate:
        groups = _dp_layout(items)
        if mixed_pack:
            groups = _merge_adjacent(groups, kmax=kmax)
    else:
        buckets: Dict[Tuple[int, int], list] = {}
        for name, v, c in items:
            if packing:
                key = _pack_choice(len(v))
            elif ladder == "pow2":
                key = (_next_pow2(len(v), floor), 1)
            else:
                key = (max(floor, -(-len(v) // 128) * 128), 1)
            buckets.setdefault(key, []).append((name, v, c))
        groups = sorted(buckets.items())

    out = []
    for (V, pack), group in groups:
        bounds, phys_rows = None, 0
        if mixed_pack and packing and consolidate and len(group) > 1:
            # adopt the k-way mixed packing where it models cheaper than
            # the bucket's uniform class
            m_members, m_widths, m_rows = _mixed_kpack(group, kmax=kmax)
            if (_mixed_cost(m_members, m_widths, m_rows)
                    < _bucket_cost(group, V, pack)):
                group = m_members
                bounds, phys_rows = m_widths, m_rows
                pack = int(m_widths.shape[1])
                V = max(len(v) for _, v, _ in group)
        B = len(group)
        values = np.zeros((B, V), np.float64)
        counts = np.zeros((B, V), np.float64)
        names, n_events = [], []
        for i, (name, v, c) in enumerate(group):
            values[i, :len(v)] = v
            values[i, len(v):] = 1.0
            counts[i, :len(c)] = c
            names.append(name)
            n_events.append(int(c.sum()))
        order, tiers = compute_tiers(counts)
        out.append(ResidueBatch(names,
                                np.take_along_axis(values, order, axis=-1),
                                np.take_along_axis(counts, order, axis=-1),
                                np.asarray(n_events), tiers, pack=pack,
                                bounds=bounds, phys_rows=phys_rows))
    return out


@dataclasses.dataclass
class BatchResult:
    names: List[str]
    mcweights: np.ndarray   # (B, S, K)
    mcrates: np.ndarray     # (B, S, K)
    n_events: np.ndarray    # (B,)


def _checkpoint_key(batch: ResidueBatch, cfg: GibbsConfig,
                    engine: str) -> str:
    """Content hash of a bucket's workload; the engine tag keeps the two
    packages' (and the two engines') checkpoints apart."""
    h = hashlib.sha1()
    h.update(",".join(batch.names).encode())
    h.update(cfg.to_json().encode())
    h.update(engine.encode())
    h.update(np.ascontiguousarray(batch.counts).tobytes())
    h.update(np.ascontiguousarray(batch.values).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(path: str, batch: ResidueBatch, cfg: GibbsConfig,
                    done_blocks: int, seg_idx: int, state: MixtureState,
                    Ws: List[np.ndarray], Rs: List[np.ndarray],
                    engine: str) -> str:
    """Persist mid-run sampler state (numpy arrays); atomic via rename."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, key=_checkpoint_key(batch, cfg, engine),
        done_blocks=done_blocks, seg_idx=seg_idx,
        weights=np.asarray(state.weights), rates=np.asarray(state.rates),
        W=np.concatenate(Ws, axis=1) if Ws else np.zeros((batch.size, 0, 1)),
        R=np.concatenate(Rs, axis=1) if Rs else np.zeros((batch.size, 0, 1)))
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, batch: ResidueBatch, cfg: GibbsConfig,
                    engine: str):
    """(done_blocks, seg_idx, state, Ws, Rs) as numpy, or None when the
    checkpoint is absent or belongs to another workload or engine."""
    if not path.endswith(".npz"):
        path += ".npz"
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if str(z["key"]) != _checkpoint_key(batch, cfg, engine):
            return None
        state = MixtureState(z["weights"], z["rates"])
        Ws = [z["W"]] if z["W"].shape[1] else []
        Rs = [z["R"]] if z["R"].shape[1] else []
        return int(z["done_blocks"]), int(z["seg_idx"]), state, Ws, Rs


def resolve_engine(engine: Optional[str] = None,
                   device=None) -> Tuple[str, torch.device]:
    """Engine and device of a run: 'cuda' launches the fused kernels and
    needs a CUDA device; 'torch' runs their plain versions on ``device``
    (default the CPU). With no engine named the run takes 'cuda', or
    'torch' when the caller gives a CPU ``device``: nothing falls back to
    the CPU because no GPU was found."""
    if engine is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        engine = "torch" if cpu else "cuda"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    if device is None:
        device = "cuda" if engine == "cuda" else "cpu"
    device = torch.device(device)
    if engine == "cuda" and (device.type != "cuda"
                             or not torch.cuda.is_available()):
        raise RuntimeError(f"engine 'cuda' needs a CUDA device; got "
                           f"{device} (cuda available: "
                           f"{torch.cuda.is_available()}); pass "
                           f"engine='torch' or device='cpu' for the CPU")
    return engine, device


def _kernel_layout(batch: ResidueBatch):
    """What the kernel takes for a bucket: (values, counts, row tiers,
    seg_id, slot_take, Bs). Mixed buckets are packed on the host into
    physical (Bph, SL * 128) rows with the owning-slot tile ``seg_id``;
    their kernel state is slot-ordered (Bs = Bph * pack slots, empty ones
    included) and ``slot_take`` gathers the members back. Other buckets
    pad their lanes to a multiple of ``pack``."""
    B, V = batch.values.shape
    pack = batch.pack
    if batch.bounds is not None:
        widths = np.asarray(batch.bounds, np.int64)
        v_ph, c_ph, seg_id, slot_take = _pack_mixed(
            np.asarray(batch.values, np.float32),
            np.asarray(batch.counts, np.float32), widths, batch.phys_rows)
        Bph = widths.shape[0]
        return (v_ph.reshape(Bph, -1), c_ph.reshape(Bph, -1),
                _mixed_row_tiers(c_ph), seg_id, slot_take, Bph * pack)
    Bs = -(-B // pack) * pack
    values = np.ones((Bs, V), np.float32)
    values[:B] = batch.values
    counts = np.zeros((Bs, V), np.float32)
    counts[:B] = batch.counts
    if pack > 1:
        seg_w = 128 // pack
        tiers = packed_row_tiers(batch.tiers, seg_w, V // seg_w)
    else:
        tiers = pad_tiers_to_rows(batch.tiers, V)
    return values, counts, tiers, None, None, Bs


class _BucketRun:
    """One bucket's chains, advanced a segment at a time. :meth:`launch`
    launches the next segment (on the bucket's CUDA stream, if it has
    one) and returns without waiting; :meth:`collect` keeps the segment's
    samples, writes the checkpoint and calls ``checkpoint_cb``. The chain
    is the same for any segmentation and any interleaving with other
    buckets: every sweep reseeds from the absolute sweep index and the
    seed is salted by the bucket's names."""

    def __init__(self, batch: ResidueBatch, cfg: GibbsConfig,
                 segment_blocks: int, checkpoint_path: Optional[str],
                 checkpoint_cb, engine: str, device: torch.device,
                 stream=None):
        if checkpoint_path is not None and not checkpoint_path.endswith(
                ".npz"):
            checkpoint_path += ".npz"
        self.batch, self.cfg = batch, cfg
        self.segment_blocks = segment_blocks
        self.checkpoint_path = checkpoint_path
        self.checkpoint_cb = checkpoint_cb
        self.device, self.stream = device, stream
        B = batch.size
        K = cfg.ncomp
        pack = batch.pack
        values_np, counts_np, tiers, seg_id, slot_np, Bs = _kernel_layout(
            batch)
        values = torch.as_tensor(values_np, dtype=torch.float32,
                                 device=device)
        counts = torch.as_tensor(counts_np, dtype=torch.float32,
                                 device=device)
        mixed = seg_id is not None
        if mixed:
            seg_mask = torch.as_tensor(seg_id, device=device)
            slot_take = torch.as_tensor(slot_np, device=device)
        st0 = init_mixture_params(K, device=device)
        self.state = MixtureState(st0.weights.repeat(Bs, 1),
                                  st0.rates.repeat(Bs, 1))
        self.total_blocks = cfg.niter // cfg.g
        # salt the seed by the bucket's residue set (as the JAX package's
        # fused engine does), so buckets never share streams
        bucket_salt = zlib.crc32(",".join(batch.names).encode()) & 0x7FFFFFFF
        seed0 = (cfg.seed ^ bucket_salt) & 0x7FFFFFFF
        self.ckpt_engine = f"basicrta_torch-{engine}"
        if pack > 1:
            self.ckpt_engine += f"-p{pack}"
        if mixed:
            # the width layout decides which uniform feeds which draw, so
            # checkpoints never resume across mixed/uniform layouts
            crc = zlib.crc32(np.asarray(batch.bounds, np.int64).tobytes())
            self.ckpt_engine += f"-mx{crc & 0xffff:04x}"
        self.Ws: list = []
        self.Rs: list = []
        self.done = self.seg_idx = 0
        self._pending = None
        if checkpoint_path is not None:
            resumed = load_checkpoint(checkpoint_path, batch, cfg,
                                      self.ckpt_engine)
            if resumed is not None:
                self.done, self.seg_idx, ck, self.Ws, self.Rs = resumed
                # checkpoints hold the B members' state: scatter it back
                # into the kernel's slots (mixed) or re-pad the lanes
                w = torch.ones((Bs, K), dtype=torch.float32, device=device)
                r = torch.ones((Bs, K), dtype=torch.float32, device=device)
                rows = slot_take if mixed else slice(0, B)
                w[rows] = torch.as_tensor(ck.weights, dtype=torch.float32,
                                          device=device)
                r[rows] = torch.as_tensor(ck.rates, dtype=torch.float32,
                                          device=device)
                self.state = MixtureState(w, r)
        if pack > 1:
            fn = segment_packed if engine == "cuda" else segment_packed_torch

            def step(offset, st, nb):
                return fn(seed0, offset, st, values, counts, cfg, nb, tiers,
                          pack, seg_mask if mixed else None)
        else:
            fn = segment if engine == "cuda" else segment_torch

            def step(offset, st, nb):
                return fn(seed0, offset, st, values, counts, cfg, nb, tiers)

        def members(x):
            """Kernel rows (slots or padded lanes) -> the B members."""
            return x.index_select(0, slot_take) if mixed else x[:B]

        self._step, self._members = step, members
        if stream is not None:
            # the operands were made on the current stream
            stream.wait_stream(torch.cuda.current_stream(device))

    def _on_stream(self):
        return (contextlib.nullcontext() if self.stream is None
                else torch.cuda.stream(self.stream))

    @property
    def finished(self) -> bool:
        return self.done >= self.total_blocks

    def launch(self):
        """Launch the next segment; nothing is copied to the host."""
        nb = min(self.segment_blocks, self.total_blocks - self.done)
        with self._on_stream():
            self.state, W, R = self._step(self.done * self.cfg.g, self.state,
                                          nb)
            self._pending = (nb, self._members(W), self._members(R))

    def collect(self):
        """Take the launched segment in: samples, checkpoint, callback."""
        nb, W, R = self._pending
        self._pending = None
        keep = self.checkpoint_path is not None
        with self._on_stream():
            if keep or self.checkpoint_cb is not None:
                W, R = W.cpu().numpy(), R.cpu().numpy()
            self.Ws.append(W)
            self.Rs.append(R)
            self.done += nb
            self.seg_idx += 1
            if keep:
                ck = MixtureState(
                    self._members(self.state.weights).cpu().numpy(),
                    self._members(self.state.rates).cpu().numpy())
                save_checkpoint(self.checkpoint_path, self.batch, self.cfg,
                                self.done, self.seg_idx, ck, self.Ws,
                                self.Rs, self.ckpt_engine)
        if self.checkpoint_cb is not None:
            self.checkpoint_cb(self.seg_idx, self.state, (self.Ws, self.Rs))

    def result(self) -> BatchResult:
        """The finished run's samples on the host; removes the checkpoint."""
        if self.checkpoint_path is not None and os.path.exists(
                self.checkpoint_path):
            os.remove(self.checkpoint_path)
        with self._on_stream():
            host = [np.asarray(x.cpu()) if torch.is_tensor(x) else x
                    for x in self.Ws + self.Rs]
        n = len(self.Ws)
        return BatchResult(self.batch.names,
                           np.concatenate(host[:n], axis=1),
                           np.concatenate(host[n:], axis=1),
                           self.batch.n_events)


def _advance(runs: Sequence[_BucketRun], cfg: GibbsConfig, device,
             progress_cb) -> None:
    """Run every bucket to its end, a segment of all buckets at a time:
    each round launches the segment of every unfinished bucket before it
    takes any of them in, so buckets on streams of their own share the
    card. ``progress_cb`` fires once a round, with the sweeps every
    bucket has done."""
    while True:
        live = [r for r in runs if not r.finished]
        if not live:
            return
        for r in live:
            r.launch()
        for r in live:
            r.collect()
        if progress_cb is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            progress_cb(min(r.done for r in runs) * cfg.g, cfg.niter)


def run_batch(batch: ResidueBatch, cfg: GibbsConfig,
              segment_blocks: int = 100,
              checkpoint_path: Optional[str] = None,
              checkpoint_cb=None, progress_cb=None,
              engine: Optional[str] = None, device=None) -> BatchResult:
    """Run full chains for one bucket of residues.

    Args:
        segment_blocks: thinning blocks per kernel launch (checkpoint and
            progress granularity; 100 blocks = 10,000 sweeps by default).
        checkpoint_path: sampler state is saved there after every segment
            and a matching checkpoint is resumed from; the chain is the
            same for any segmentation.
        checkpoint_cb: optional ``f(segment_idx, state, (Ws, Rs))``.
        progress_cb: optional ``f(done_sweeps, total_sweeps)``.
        engine: 'cuda' (the fused kernels, the default) or 'torch' (their
            plain versions; see :func:`resolve_engine`). Packed buckets
            run K3 (``segment_packed``), the others K2 (``segment``).
        device: where the lanes live; defaults from the engine.
    """
    engine, device = resolve_engine(engine, device)
    run = _BucketRun(batch, cfg, segment_blocks, checkpoint_path,
                     checkpoint_cb, engine, device)
    _advance([run], cfg, device, progress_cb)
    return run.result()


def run_batches(batches: Sequence[ResidueBatch], cfg: GibbsConfig,
                segment_blocks: int = 100,
                checkpoint_paths: Optional[Sequence[Optional[str]]] = None,
                checkpoint_cb=None, progress_cb=None,
                engine: Optional[str] = None,
                device=None) -> List[BatchResult]:
    """Run full chains for several buckets, all on the device at once.

    On the card each bucket launches on a CUDA stream of its own, and the
    current segment of every bucket is launched before any bucket's samples
    are copied to the host; checkpoints (``checkpoint_paths``, one a
    bucket) and ``progress_cb`` follow the segment of all buckets. Every
    bucket's result is bitwise that of :func:`run_batch` on it alone,
    whose other arguments these are."""
    engine, device = resolve_engine(engine, device)
    if checkpoint_paths is None:
        checkpoint_paths = [None] * len(batches)
    runs = [_BucketRun(b, cfg, segment_blocks, path, checkpoint_cb, engine,
                       device, torch.cuda.Stream(device)
                       if device.type == "cuda" else None)
            for b, path in zip(batches, checkpoint_paths)]
    _advance(runs, cfg, device, progress_cb)
    return [run.result() for run in runs]


def run_residues(times_per_residue: Dict[str, np.ndarray], cfg: GibbsConfig,
                 n_chains: int = 1, checkpoint_dir: Optional[str] = None,
                 ladder: Optional[str] = "engine",
                 **kwargs) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """All residues: bucket, then run every bucket on the device at
    once (:func:`run_batches`).

    Chains are extra lanes (the residue repeated as ``name#chain``).
    Residues with no events are omitted. ``ladder`` picks the layout:
    'engine' follows the engine as the JAX package does (the production
    layout for 'cuda', the pow2 ladder for 'torch'); None forces the
    production layout and 'pow2' the pow2 ladder. ``kwargs`` go to
    :func:`run_batches` (engine, device, progress_cb, checkpoint_cb,
    segment_blocks); ``checkpoint_dir`` holds one checkpoint a bucket.

    Returns:
        {residue: (mcweights (chains, S, K), mcrates (chains, S, K))}
    """
    nonempty = {name: t for name, t in times_per_residue.items()
                if len(t) > 0}
    expanded = {f"{name}#{ch}": t for name, t in nonempty.items()
                for ch in range(n_chains)}
    out: Dict[str, list] = {name: [None] * n_chains for name in nonempty}
    engine, device = resolve_engine(kwargs.pop("engine", None),
                                    kwargs.pop("device", None))
    if ladder == "engine":
        ladder = None if engine == "cuda" else "pow2"
    batches = bucket_residues(expanded, ladder=ladder)
    paths = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        paths = [os.path.join(checkpoint_dir, "ckpt_" + _checkpoint_key(
            b, cfg, f"basicrta_torch-{engine}") + ".npz") for b in batches]
    for res in run_batches(batches, cfg, checkpoint_paths=paths,
                           engine=engine, device=device, **kwargs):
        for i, lane_name in enumerate(res.names):
            name, ch = lane_name.rsplit("#", 1)
            out[name][int(ch)] = (res.mcweights[i], res.mcrates[i])
    return {name: (np.stack([w for w, _ in chains]),
                   np.stack([r for _, r in chains]))
            for name, chains in out.items()}
