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

Three engines advance a bucket: 'cuda' (the fused kernels), 'torch' (their
plain versions, draw for draw) and 'collapsed', the counterpart of the JAX
package's ``xla`` engine: the reference collapsed sweep of
:mod:`basicrta_torch.sampler.kernels` as batched torch ops over the
bucket's (lanes, V) layout, written apart from the kernels, so the
kernels can be held against it in law. Its lanes share one generator a
segment, seeded from (seed, bucket, segment index): a resumed run is
bitwise the uninterrupted one, and each lane is independent of its mates
in law.
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

from basicrta_torch import spans
from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops.random import seeded_generator
from basicrta_torch.sampler.cuda_sweep import (_int32, pad_tiers_to_rows,
                                               packed_row_tiers, segment,
                                               segment_packed,
                                               segment_packed_torch,
                                               segment_torch)
from basicrta_torch.sampler.kernels import (SMALL_NMAX, MixtureState,
                                            _thinned_scan, collapsed_sweep,
                                            compute_tiers, dedup_times,
                                            init_mixture_params)

ENGINES = ("cuda", "torch", "collapsed")


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
    with spans.span("sampler.layout"):
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


def resolve_engine(engine: Optional[str] = None, device=None,
                   sharding=None) -> Tuple[str, torch.device]:
    """Engine and device of a run: 'cuda' launches the fused kernels and
    needs a CUDA device; 'torch' runs their plain versions on ``device``
    (default the CPU); 'collapsed' runs the reference collapsed sweep on
    ``device`` (default the card). With no engine named the run takes
    'cuda', or 'torch' when the caller gives a CPU ``device``: nothing
    falls back to the CPU because no GPU was found. A ``sharding`` names
    the devices itself (its mesh's kind is the device); the kernel engines
    keep each lane's value axis whole and refuse a mesh with events > 1."""
    if sharding is not None:
        kinds = {d.type for d in sharding.mesh.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh of one device kind; got {kinds}")
        mesh_device = sharding.mesh.devices[0, 0]
        if device is not None and torch.device(device).type != \
                mesh_device.type:
            raise ValueError(f"device {device} and a mesh of "
                             f"{mesh_device.type} devices disagree")
        device = mesh_device
        if engine in ("cuda", "torch") and \
                sharding.mesh.shape["events"] > 1:
            raise ValueError(
                f"the {engine!r} engine keeps each lane's full value axis "
                "in one kernel and cannot split it: use a mesh of events "
                "= 1 (lane sharding), or engine='collapsed' for event "
                "sharding")
    if engine is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        engine = "torch" if cpu else "cuda"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    if device is None:
        device = "cpu" if engine == "torch" else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"engine {engine!r} on {device} needs a CUDA "
                           f"device and none is available; pass "
                           f"device='cpu' for the CPU")
    if engine == "cuda" and device.type != "cuda":
        raise RuntimeError(f"engine 'cuda' needs a CUDA device; got "
                           f"{device}; pass engine='torch' or device='cpu' "
                           f"for the CPU")
    return engine, device


def _segment(generator: torch.Generator, state: MixtureState,
             values: torch.Tensor, counts: torch.Tensor, cfg: GibbsConfig,
             n_blocks: int, tiers: Optional[Tuple[int, int]] = None):
    """The collapsed engine's segment: every lane of (lanes, V) advances by
    ``n_blocks * g`` reference collapsed sweeps. Returns the advanced
    state and the (lanes, n_blocks, K) thinned samples."""
    def sweep(gen, st):
        return collapsed_sweep(gen, st, values, counts, cfg, tiers=tiers)[0]
    return _thinned_scan(sweep, generator, state, cfg.g, n_blocks)


# lane shard s of a kernel engine seeds its launches with seed0 + s * this
# (int32 wrap-around), as the JAX package's lane-sharded fused engine does:
# the kernels' lane ids restart at 0 on every shard
_SHARD_SEED_STRIDE = 0x3504F333


def _mesh_tag(sharding) -> str:
    """The checkpoint tag of a mesh: sharded chains draw other streams, so
    checkpoints never resume across mesh shapes (a one-shard mesh is the
    unsharded run and shares its tag)."""
    if sharding is None:
        return ""
    return ((f"-l{sharding.n_lanes}" if sharding.n_lanes > 1 else "")
            + (f"-ev{sharding.n_events}" if sharding.n_events > 1 else ""))


def _kernel_layout(batch: ResidueBatch, n_lanes: int = 1):
    """What the kernel takes for a bucket split over ``n_lanes`` lane
    shards: (values, counts, row tiers, seg_id, slot_take, Bs). Mixed
    buckets are packed on the host into physical (Bph, SL * 128) rows with
    the owning-slot tile ``seg_id``, their physical lanes padded with
    zero-width rows to a multiple of ``n_lanes``; their kernel state is
    slot-ordered (Bs = Bph * pack slots, empty ones included) and
    ``slot_take`` gathers the members back. Other buckets pad their lanes
    to a multiple of ``n_lanes * pack``. Lane shard s takes the s-th of
    ``n_lanes`` equal runs of the rows."""
    B, V = batch.values.shape
    pack = batch.pack
    if batch.bounds is not None:
        widths = np.asarray(batch.bounds, np.int64)
        Bph = -(-widths.shape[0] // n_lanes) * n_lanes
        padded = np.zeros((Bph, pack), np.int64)
        padded[:widths.shape[0]] = widths
        v_ph, c_ph, seg_id, slot_take = _pack_mixed(
            np.asarray(batch.values, np.float32),
            np.asarray(batch.counts, np.float32), padded, batch.phys_rows)
        return (v_ph.reshape(Bph, -1), c_ph.reshape(Bph, -1),
                _mixed_row_tiers(c_ph), seg_id, slot_take, Bph * pack)
    Bs = -(-B // (n_lanes * pack)) * (n_lanes * pack)
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


def _on_stream(stream):
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


@dataclasses.dataclass
class _Shard:
    """One lane shard of a bucket: its rows of the operands and of the
    chain state on its device, its stream and its kernel seed."""
    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    values: torch.Tensor
    counts: torch.Tensor
    seg_mask: Optional[torch.Tensor]
    state: MixtureState
    seed: int


class _BucketRun:
    """One bucket's chains, advanced a segment at a time. :meth:`launch`
    launches the next segment of every lane shard (each on its stream, if
    it has one) and returns without waiting; :meth:`collect` takes the
    segment in, launches the next one and only then writes the checkpoint
    and calls ``checkpoint_cb``, so the file is written while the card
    runs. The chain is the same for any segmentation and any interleaving
    with other buckets: every sweep reseeds from the absolute sweep index
    and the seed is salted by the bucket's names (and, on a mesh of n > 1
    lane shards, by the shard). Its spans (:mod:`basicrta_torch.spans`):
    ``sampler.segment`` the launch, ``sampler.wait`` the host waiting on
    the segment's samples and state, ``sampler.checkpoint`` the file
    written (counters ``bytes``, and ``behind``: 1, the bucket's next
    segment being in flight)."""

    def __init__(self, batch: ResidueBatch, cfg: GibbsConfig,
                 segment_blocks: int, checkpoint_path: Optional[str],
                 checkpoint_cb, engine: str, device: torch.device,
                 streams: bool = False, sharding=None):
        if checkpoint_path is not None and not checkpoint_path.endswith(
                ".npz"):
            checkpoint_path += ".npz"
        self.batch, self.cfg = batch, cfg
        self.segment_blocks = segment_blocks
        self.checkpoint_path = checkpoint_path
        self.checkpoint_cb = checkpoint_cb
        B, V = batch.values.shape
        K = cfg.ncomp
        pack = batch.pack
        n_lanes = 1 if sharding is None else sharding.n_lanes
        n_events = 1 if sharding is None else sharding.n_events
        devices = ([device] if sharding is None
                   else sharding.mesh.axis_devices("lanes"))
        if engine == "collapsed":
            # the logical (lanes, V) layout, as the JAX xla engine runs it,
            # lanes padded to the shard count
            Bs = -(-B // n_lanes) * n_lanes
            values_np = np.ones((Bs, V))
            values_np[:B] = batch.values
            counts_np = np.zeros((Bs, V))
            counts_np[:B] = batch.counts
            tiers, seg_id, slot_np = batch.tiers, None, None
            if n_events > 1:
                # deal sorted columns cyclically so one tier pair covers
                # every event shard; the mesh step splits lanes and columns
                # itself, so the bucket is one unit
                from basicrta_torch.parallel.mesh import deal_columns
                values_np, counts_np, tiers = deal_columns(
                    values_np, counts_np, n_events, batch.tiers)
                devices = devices[:1]
        else:
            values_np, counts_np, tiers, seg_id, slot_np, Bs = (
                _kernel_layout(batch, n_lanes))
        mixed = seg_id is not None
        st0 = init_mixture_params(K)
        w, r = st0.weights.repeat(Bs, 1), st0.rates.repeat(Bs, 1)
        self.total_blocks = cfg.niter // cfg.g
        # salt the seed by the bucket's residue set (as the JAX package's
        # fused engine does), so buckets never share streams
        salt = zlib.crc32(",".join(batch.names).encode()) & 0x7FFFFFFF
        seed0 = (cfg.seed ^ salt) & 0x7FFFFFFF
        self.ckpt_engine = f"basicrta_torch-{engine}{_mesh_tag(sharding)}"
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
                rows = slot_np if mixed else slice(0, B)
                w, r = torch.ones((Bs, K)), torch.ones((Bs, K))
                w[rows] = torch.as_tensor(ck.weights, dtype=torch.float32)
                r[rows] = torch.as_tensor(ck.rates, dtype=torch.float32)
        from basicrta_torch.parallel.mesh import split_rows
        vrows = split_rows(len(values_np), len(devices))
        srows = split_rows(Bs, len(devices))
        self.shards = []
        for s, dev in enumerate(devices):
            stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                      and (streams or len(devices) > 1) else None)
            vr = vrows[s]
            self.shards.append(_Shard(
                s, dev, stream,
                torch.as_tensor(values_np[vr], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(counts_np[vr], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(seg_id[vr], device=dev) if mixed else None,
                MixtureState(w[srows[s]].to(dev), r[srows[s]].to(dev)),
                _int32(seed0 + s * _SHARD_SEED_STRIDE)))
            if stream is not None:
                # the operands were made on the current stream
                stream.wait_stream(torch.cuda.current_stream(dev))

        if engine == "collapsed" and n_events > 1:
            from basicrta_torch.parallel.mesh import event_sharded_blocks

            def step(sh, nb):
                return event_sharded_blocks(sharding.mesh, cfg, nb, tiers)(
                    (cfg.seed, salt, self.seg_idx), sh.state, sh.values,
                    sh.counts)
        elif engine == "collapsed":
            def step(sh, nb):
                # one generator a segment, and a shard on a mesh of n > 1
                ids = (cfg.seed, salt, self.seg_idx) + (
                    (sh.index,) if len(self.shards) > 1 else ())
                return _segment(seeded_generator(sh.device, *ids), sh.state,
                                sh.values, sh.counts, cfg, nb, tiers)
        elif pack > 1:
            fn = segment_packed if engine == "cuda" else segment_packed_torch

            def step(sh, nb):
                return fn(sh.seed, self.done * cfg.g, sh.state, sh.values,
                          sh.counts, cfg, nb, tiers, pack, sh.seg_mask)
        else:
            fn = segment if engine == "cuda" else segment_torch

            def step(sh, nb):
                return fn(sh.seed, self.done * cfg.g, sh.state, sh.values,
                          sh.counts, cfg, nb, tiers)

        self._step = step
        self._members = ((lambda x: x[slot_np]) if mixed
                         else (lambda x: x[:B]))

    @property
    def state(self) -> MixtureState:
        """The chain state of every kernel row (slots or padded lanes), on
        the first shard's device."""
        if len(self.shards) == 1:
            return self.shards[0].state
        home = self.shards[0].device
        return MixtureState(*(torch.cat([getattr(sh.state, f).to(home)
                                         for sh in self.shards])
                              for f in MixtureState._fields))

    def _gather(self, parts) -> np.ndarray:
        """Per-shard tensors of kernel rows -> the B members, on the
        host."""
        host = []
        for sh, x in zip(self.shards, parts):
            with _on_stream(sh.stream):
                host.append(x.cpu().numpy())
        return self._members(np.concatenate(host))

    @property
    def finished(self) -> bool:
        return self.done >= self.total_blocks

    def launch(self):
        """Launch the next segment of every shard, and a CUDA event behind
        it on each card; nothing is copied to the host."""
        nb = min(self.segment_blocks, self.total_blocks - self.done)
        outs, events = [], []
        with spans.span("sampler.segment"):
            for sh in self.shards:
                with _on_stream(sh.stream):
                    sh.state, W, R = self._step(sh, nb)
                outs.append((W, R))
                if sh.device.type == "cuda":
                    events.append(_record_event(sh))
        self._pending = (nb, [W for W, _ in outs], [R for _, R in outs],
                         events)

    def collect(self) -> list:
        """Take the launched segment in (its samples, and its state where a
        checkpoint is kept), launch the bucket's next segment, then write
        the checkpoint of the segment taken in and call ``checkpoint_cb``
        with its state. The segment that finishes the bucket writes no
        checkpoint: :meth:`result` would remove it unread. The kernels
        allocate a fresh state every launch, so the state taken in stays
        as it was. Returns the CUDA events of the segment taken in."""
        nb, W, R, events = self._pending
        self._pending = None
        keep = self.checkpoint_path is not None
        if keep or self.checkpoint_cb is not None:
            with spans.span("sampler.wait"):
                W, R = self._gather(W), self._gather(R)
                if keep:
                    # before the next launch, which the copy would wait on
                    ck = MixtureState(
                        self._gather([sh.state.weights
                                      for sh in self.shards]),
                        self._gather([sh.state.rates for sh in self.shards]))
        state = self.state if self.checkpoint_cb is not None else None
        self.Ws.append(W)
        self.Rs.append(R)
        self.done += nb
        self.seg_idx += 1
        if not self.finished:
            self.launch()
            if keep:
                with spans.span("sampler.checkpoint"):
                    path = save_checkpoint(self.checkpoint_path, self.batch,
                                           self.cfg, self.done, self.seg_idx,
                                           ck, self.Ws, self.Rs,
                                           self.ckpt_engine)
                    if spans.recording():
                        spans.add("bytes", os.path.getsize(path))
                        spans.add("behind")
        if self.checkpoint_cb is not None:
            self.checkpoint_cb(self.seg_idx, state, (self.Ws, self.Rs))
        return events

    def result(self) -> BatchResult:
        """The finished run's samples on the host; removes the checkpoint."""
        if self.checkpoint_path is not None and os.path.exists(
                self.checkpoint_path):
            os.remove(self.checkpoint_path)
        W, R = ([x if isinstance(x, np.ndarray) else self._gather(x)
                 for x in xs] for xs in (self.Ws, self.Rs))
        return BatchResult(self.batch.names, np.concatenate(W, axis=1),
                           np.concatenate(R, axis=1), self.batch.n_events)


def _advance(runs: Sequence[_BucketRun], cfg: GibbsConfig,
             progress_cb) -> None:
    """Run every bucket to its end. The first segment of every unfinished
    bucket (and of every lane shard) is launched before any is taken in,
    and each bucket's next segment is launched as soon as its last one is
    taken in, so buckets and shards on streams of their own share the
    cards and checkpoints are written while they run. ``progress_cb``
    fires once a round of all buckets, with the sweeps every bucket has
    taken in."""
    for r in runs:
        if not r.finished:
            r.launch()
    while True:
        live = [r for r in runs if r._pending is not None]
        if not live:
            return
        taken = [e for r in live for e in r.collect()]
        if progress_cb is not None:
            for event in taken:
                event.synchronize()
            progress_cb(min(r.done for r in runs) * cfg.g, cfg.niter)


def run_batch(batch: ResidueBatch, cfg: GibbsConfig,
              segment_blocks: int = 100,
              checkpoint_path: Optional[str] = None,
              checkpoint_cb=None, progress_cb=None,
              engine: Optional[str] = None, device=None,
              sharding=None, defer_transfer: bool = False):
    """Run full chains for one bucket of residues.

    Args:
        segment_blocks: thinning blocks per kernel launch (checkpoint and
            progress granularity; 100 blocks = 10,000 sweeps by default).
        checkpoint_path: sampler state is saved there after every segment
            but the last, while the next one runs, and a matching
            checkpoint is resumed from; the chain is the same for any
            segmentation. A finished run leaves no checkpoint.
        checkpoint_cb: optional ``f(segment_idx, state, (Ws, Rs))``, after
            each segment, with the state that segment ended in.
        progress_cb: optional ``f(done_sweeps, total_sweeps)``.
        engine: 'cuda' (the fused kernels, the default), 'torch' (their
            plain versions) or 'collapsed' (the reference collapsed sweep;
            see :func:`resolve_engine`). On 'cuda' packed buckets run K3
            (``segment_packed``), the others K2 (``segment``).
        device: where the lanes live; defaults from the engine, or from
            the mesh.
        sharding: a :func:`~basicrta_torch.parallel.mesh.lane_sharding`
            splits the lanes over the mesh's lane shards, each launching
            on its own device and stream with its own seed (a mesh of n > 1
            shards gives other chains than the unsharded run; n = 1 gives
            the same); an ``event_sharding`` with events > 1 also splits
            the value columns, on the 'collapsed' engine only.
        defer_transfer: return a ``_DeferredBatch`` whose thinned samples
            are still on the device, with a CUDA event recorded after the
            last launch of each lane shard: pass it to
            :func:`finalize_batch`. A caller running several buckets
            launches the next bucket before this one's samples are copied.

    Returns:
        :class:`BatchResult`, or a ``_DeferredBatch`` when
        ``defer_transfer=True``.
    """
    engine, device = resolve_engine(engine, device, sharding)
    run = _BucketRun(batch, cfg, segment_blocks, checkpoint_path,
                     checkpoint_cb, engine, device, sharding=sharding)
    _advance([run], cfg, progress_cb)
    if not defer_transfer:
        return run.result()
    return _DeferredBatch(run, [_record_event(sh) for sh in run.shards
                                if sh.device.type == "cuda"])


def _record_event(shard: _Shard) -> "torch.cuda.Event":
    """A CUDA event after the last work queued on ``shard``'s stream."""
    event = torch.cuda.Event()
    event.record(shard.stream if shard.stream is not None
                 else torch.cuda.current_stream(shard.device))
    return event


@dataclasses.dataclass
class _DeferredBatch:
    """run_batch output with the samples still on the device
    (``defer_transfer=True``): the finished run and one CUDA event a lane
    shard on a card."""
    run: _BucketRun
    events: list


def finalize_batch(deferred) -> BatchResult:
    """Wait on a ``defer_transfer=True`` result's events and copy its
    samples to the host; a :class:`BatchResult` is returned as it is."""
    if isinstance(deferred, BatchResult):
        return deferred
    for event in deferred.events:
        event.synchronize()
    return deferred.run.result()


def run_batches(batches: Sequence[ResidueBatch], cfg: GibbsConfig,
                segment_blocks: int = 100,
                checkpoint_paths: Optional[Sequence[Optional[str]]] = None,
                checkpoint_cb=None, progress_cb=None,
                engine: Optional[str] = None,
                device=None, sharding=None) -> List[BatchResult]:
    """Run full chains for several buckets, all on the device at once.

    On the card each bucket (and each of its lane shards) launches on a
    CUDA stream of its own, and the first segment of every bucket is
    launched before any bucket's samples are copied to the host; a
    bucket's checkpoint (``checkpoint_paths``, one a bucket) is written
    while its next segment runs, and ``progress_cb`` follows the segment
    of all buckets. Every bucket's result is bitwise
    that of :func:`run_batch` on it alone, whose other arguments these
    are."""
    engine, device = resolve_engine(engine, device, sharding)
    if checkpoint_paths is None:
        checkpoint_paths = [None] * len(batches)
    runs = [_BucketRun(b, cfg, segment_blocks, path, checkpoint_cb, engine,
                       device, streams=True, sharding=sharding)
            for b, path in zip(batches, checkpoint_paths)]
    _advance(runs, cfg, progress_cb)
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
    layout for 'cuda', the pow2 ladder for 'torch' and 'collapsed', as
    for the JAX package's 'xla'); None forces the
    production layout and 'pow2' the pow2 ladder. ``kwargs`` go to
    :func:`run_batches` (engine, device, sharding, progress_cb,
    checkpoint_cb, segment_blocks); ``checkpoint_dir`` holds one
    checkpoint a bucket, named by the engine and the mesh.

    Returns:
        {residue: (mcweights (chains, S, K), mcrates (chains, S, K))}
    """
    nonempty = {name: t for name, t in times_per_residue.items()
                if len(t) > 0}
    expanded = {f"{name}#{ch}": t for name, t in nonempty.items()
                for ch in range(n_chains)}
    out: Dict[str, list] = {name: [None] * n_chains for name in nonempty}
    sharding = kwargs.get("sharding")
    kwargs.pop("defer_transfer", None)   # every bucket is on the card at once
    engine, device = resolve_engine(kwargs.pop("engine", None),
                                    kwargs.pop("device", None), sharding)
    if ladder == "engine":
        ladder = None if engine == "cuda" else "pow2"
    batches = bucket_residues(expanded, ladder=ladder)
    paths = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        tag = f"basicrta_torch-{engine}{_mesh_tag(sharding)}"
        paths = [os.path.join(checkpoint_dir, "ckpt_" + _checkpoint_key(
            b, cfg, tag) + ".npz") for b in batches]
    for res in run_batches(batches, cfg, checkpoint_paths=paths,
                           engine=engine, device=device, **kwargs):
        for i, lane_name in enumerate(res.names):
            name, ch = lane_name.rsplit("#", 1)
            out[name][int(ch)] = (res.mcweights[i], res.mcrates[i])
    return {name: (np.stack([w for w, _ in chains]),
                   np.stack([r for _, r in chains]))
            for name, chains in out.items()}
