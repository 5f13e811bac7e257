"""Batched multi-residue Gibbs sampling.

Port of ``basicrta_tpu.sampler.batch`` on the power-of-two bucket ladder:
every residue (x every chain) is one lane of a bucket, lanes of a bucket
share one value width, and each host-level segment of ``segment_blocks``
thinning blocks is one launch of the fused sweep kernel
(:func:`basicrta_torch.sampler.cuda_sweep.segment`). Segments checkpoint
and resume exactly, because the kernel reseeds every sweep from the
absolute sweep index.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler.cuda_sweep import pad_tiers_to_rows, segment, \
    segment_torch
from basicrta_torch.sampler.kernels import (MixtureState, compute_tiers,
                                            dedup_times, init_mixture_params)

ENGINES = ("auto", "cuda", "torch")


def _next_pow2(n: int, floor: int = 128, step: int = 2) -> int:
    """Smallest floor * step^k >= n."""
    b = floor
    while b < n:
        b *= step
    return b


@dataclasses.dataclass
class ResidueBatch:
    """A padded, stacked bucket of residues; value columns are sorted by
    multiplicity descending per lane, padding has count 0 and value 1."""
    names: List[str]               # residue labels, length B
    values: np.ndarray             # (B, V) unique residence times
    counts: np.ndarray             # (B, V) multiplicities, 0 marks padding
    n_events: np.ndarray           # (B,) true event count per residue
    tiers: Tuple[int, int] = (0, 0)  # column tier boundaries

    @property
    def size(self) -> int:
        return len(self.names)


def bucket_residues(times_per_residue: Dict[str, np.ndarray],
                    floor: Optional[int] = None) -> List[ResidueBatch]:
    """Group residues into power-of-two unique-count buckets (the layout
    ``basicrta_tpu`` gives its XLA engine with ``ladder='pow2'``): V is
    the smallest ``floor * 2^k`` (floor 128) covering a residue's unique
    values, so every bucket is a whole number of 128-column rows."""
    buckets: Dict[int, list] = {}
    for name, t in times_per_residue.items():
        if len(t) == 0:
            continue
        v, c = dedup_times(t)
        buckets.setdefault(_next_pow2(len(v), floor or 128), []).append(
            (name, v, c))
    out = []
    for V, group in sorted(buckets.items()):
        B = len(group)
        values = np.ones((B, V), np.float64)
        counts = np.zeros((B, V), np.float64)
        names, n_events = [], []
        for i, (name, v, c) in enumerate(group):
            values[i, :len(v)] = v
            counts[i, :len(c)] = c
            names.append(name)
            n_events.append(int(c.sum()))
        order, tiers = compute_tiers(counts)
        out.append(ResidueBatch(names,
                                np.take_along_axis(values, order, axis=-1),
                                np.take_along_axis(counts, order, axis=-1),
                                np.asarray(n_events), tiers))
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


def resolve_engine(engine: str, device=None) -> Tuple[str, torch.device]:
    """Engine and device of a run: 'cuda' launches the kernel and needs a
    CUDA device; 'torch' runs the plain version on ``device`` (default the
    CPU); 'auto' is 'cuda' on a CUDA device and 'torch' on the CPU."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    if device is None:
        cuda = engine == "cuda" or (engine == "auto"
                                    and torch.cuda.is_available())
        device = torch.device("cuda" if cuda else "cpu")
    device = torch.device(device)
    if engine == "auto":
        engine = "cuda" if device.type == "cuda" else "torch"
    if engine == "cuda" and (device.type != "cuda"
                             or not torch.cuda.is_available()):
        raise RuntimeError(f"engine 'cuda' needs a CUDA device; got "
                           f"{device} (cuda available: "
                           f"{torch.cuda.is_available()})")
    return engine, device


def run_batch(batch: ResidueBatch, cfg: GibbsConfig,
              segment_blocks: int = 100,
              checkpoint_path: Optional[str] = None,
              checkpoint_cb=None, progress_cb=None, engine: str = "auto",
              device=None) -> BatchResult:
    """Run full chains for one bucket of residues.

    Args:
        segment_blocks: thinning blocks per kernel launch (checkpoint and
            progress granularity; 100 blocks = 10,000 sweeps by default).
        checkpoint_path: sampler state is saved there after every segment
            and a matching checkpoint is resumed from; the chain is the
            same for any segmentation.
        checkpoint_cb: optional ``f(segment_idx, state, (Ws, Rs))``.
        progress_cb: optional ``f(done_sweeps, total_sweeps)``.
        engine: 'cuda' (the fused kernel), 'torch' (its plain version) or
            'auto' (see :func:`resolve_engine`).
        device: where the lanes live; defaults from the engine.
    """
    engine, device = resolve_engine(engine, device)
    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"
    B, V = batch.values.shape
    K = cfg.ncomp
    values = torch.as_tensor(batch.values, dtype=torch.float32,
                             device=device)
    counts = torch.as_tensor(batch.counts, dtype=torch.float32,
                             device=device)
    st0 = init_mixture_params(K, device=device)
    state = MixtureState(st0.weights.repeat(B, 1), st0.rates.repeat(B, 1))
    total_blocks = cfg.niter // cfg.g
    # salt the seed by the bucket's residue set (as the JAX package's
    # fused engine does), so buckets never share streams
    bucket_salt = zlib.crc32(",".join(batch.names).encode()) & 0x7FFFFFFF
    seed0 = (cfg.seed ^ bucket_salt) & 0x7FFFFFFF
    ckpt_engine = f"basicrta_torch-{engine}"
    Ws: list = []
    Rs: list = []
    done = seg_idx = 0
    if checkpoint_path is not None:
        resumed = load_checkpoint(checkpoint_path, batch, cfg, ckpt_engine)
        if resumed is not None:
            done, seg_idx, ck, Ws, Rs = resumed
            state = MixtureState(
                torch.as_tensor(ck.weights, dtype=torch.float32,
                                device=device),
                torch.as_tensor(ck.rates, dtype=torch.float32,
                                device=device))
    tiers = pad_tiers_to_rows(batch.tiers, V)
    step = segment if engine == "cuda" else segment_torch
    while done < total_blocks:
        nb = min(segment_blocks, total_blocks - done)
        state, W, R = step(seed0, done * cfg.g, state, values, counts, cfg,
                           nb, tiers)
        if checkpoint_path is not None or checkpoint_cb is not None:
            W, R = W.cpu().numpy(), R.cpu().numpy()
        Ws.append(W)
        Rs.append(R)
        done += nb
        seg_idx += 1
        if checkpoint_path is not None:
            ck = MixtureState(state.weights.cpu().numpy(),
                              state.rates.cpu().numpy())
            save_checkpoint(checkpoint_path, batch, cfg, done, seg_idx, ck,
                            Ws, Rs, ckpt_engine)
        if checkpoint_cb is not None:
            checkpoint_cb(seg_idx, state, (Ws, Rs))
        if progress_cb is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            progress_cb(done * cfg.g, cfg.niter)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    host = [np.asarray(x.cpu()) if torch.is_tensor(x) else x
            for x in Ws + Rs]
    n = len(Ws)
    return BatchResult(batch.names, np.concatenate(host[:n], axis=1),
                       np.concatenate(host[n:], axis=1), batch.n_events)


def run_residues(times_per_residue: Dict[str, np.ndarray], cfg: GibbsConfig,
                 n_chains: int = 1, checkpoint_dir: Optional[str] = None,
                 **kwargs) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """All-residue driver: bucket, then run each bucket on the device.

    Chains are extra lanes (the residue repeated as ``name#chain``).
    Residues with no events are omitted. ``kwargs`` go to
    :func:`run_batch` (engine, device, progress_cb, segment_blocks).

    Returns:
        {residue: (mcweights (chains, S, K), mcrates (chains, S, K))}
    """
    nonempty = {name: t for name, t in times_per_residue.items()
                if len(t) > 0}
    expanded = {f"{name}#{ch}": t for name, t in nonempty.items()
                for ch in range(n_chains)}
    out: Dict[str, list] = {name: [None] * n_chains for name in nonempty}
    engine, _ = resolve_engine(kwargs.get("engine", "auto"),
                               kwargs.get("device"))
    for batch in bucket_residues(expanded):
        ckpt = None
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            key = _checkpoint_key(batch, cfg, f"basicrta_torch-{engine}")
            ckpt = os.path.join(checkpoint_dir, f"ckpt_{key}.npz")
        res = run_batch(batch, cfg, checkpoint_path=ckpt, **kwargs)
        for i, lane_name in enumerate(res.names):
            name, ch = lane_name.rsplit("#", 1)
            out[name][int(ch)] = (res.mcweights[i], res.mcrates[i])
    return {name: (np.stack([w for w, _ in chains]),
                   np.stack([r for _, r in chains]))
            for name, chains in out.items()}
