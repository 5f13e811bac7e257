"""Bucketed cross-residue posterior processing.

Port of ``basicrta_tpu.postprocess.batched``. Residues are bucketed by
(lmode, padded training rows, padded data rows) for the GMM and by
(padded value count, sample shape) for the votes, and each bucket runs as
one batched program: one EM over (residues x restarts) with one host sync
per iteration, and one vote pass whose multinomial chain covers the whole
bucket. Padded training rows take weight 0; padded data rows and value
columns are sliced off or carry count 0.

Every residue draws from torch generators of its own, seeded from
(cfg.seed + 1, crc32(name), stage), and the vote pass chunks each
residue's samples by its own shape only, so a residue's result does not
depend on which residues share its bucket.

Per-residue semantics are ``clustering.process_samples`` (reference
gibbs.py:275-308): burn-in and weight-cutoff filtering, the modal
component count, GMM labels of log(weight, rate), votes, rate-sorted
relabelling. One difference from the JAX package: the vote one-hot is
built at each chain's own K (the JAX package builds it at ``cfg.ncomp``,
which loses the votes of labels >= ``cfg.ncomp`` when a chain has more
components than the config names).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.postprocess.clustering import (ClusterResult,
                                                   _label_matrix,
                                                   component_counts,
                                                   gather_cluster_data,
                                                   select_lmode,
                                                   sort_labels_by_rate,
                                                   VOTE_CHUNK, votes_bucket)
from basicrta_torch.postprocess.gmm import fit_predict_batched
from basicrta_torch.sampler.batch import _next_pow2

_GMM_ELEMS = 1 << 26    # (residue x restart x row x component) per EM pass
_VOTE_BATCH = 1 << 25   # vote entries of one pass, over its residues


def _pad_size(n: int, floor: int = 128, step: int = 4) -> int:
    """Geometric pad ladder (4x steps from 128), as the JAX package's."""
    return _next_pow2(n, floor=floor, step=step)


def select_chain(mcweights: np.ndarray, mcrates: np.ndarray, chain,
                 burnin_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gibbs.process_gibbs chain selection: an index, or 'pooled' to
    concatenate post-burn-in samples of all chains behind one burn-in-sized
    prefix."""
    if chain == "pooled" and mcweights.shape[0] > 1:
        b = burnin_samples
        W = np.concatenate([mcweights[0][:b]] + [c[b:] for c in mcweights])
        R = np.concatenate([mcrates[0][:b]] + [c[b:] for c in mcrates])
        return W, R
    idx = 0 if chain == "pooled" else chain
    return mcweights[idx], mcrates[idx]


def residue_generator(cfg: GibbsConfig, name: str, salt: int,
                      device) -> torch.Generator:
    """The generator of one residue's post-processing stage ``salt`` (0
    the GMM, 1 the votes), seeded from (cfg.seed + 1, crc32(name), salt)."""
    crc = zlib.crc32(str(name).encode()) & 0x7FFFFFFF
    gen = torch.Generator(device=device)
    gen.manual_seed(((cfg.seed + 1) * 1_000_003 + crc) * 2 + salt)
    return gen


def _chunks(n: int, per_item: int, budget: int) -> List[slice]:
    step = max(1, budget // max(1, per_item))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _gmm_bucket(prepared: dict, names: List[str], lmode: int, Mt_p: int,
                M_p: int, cfg: GibbsConfig, device) -> None:
    """One bucket's GMM fits; fills ``prepared[name]['labels']``."""
    R = cfg.gmm_n_init
    for part in _chunks(len(names), R * Mt_p * max(lmode, 1), _GMM_ELEMS):
        sub = names[part]
        Bk = len(sub)
        train = np.zeros((Bk, Mt_p, 2), np.float64)
        train_w = np.zeros((Bk, Mt_p), np.float32)
        data = np.ones((Bk, M_p, 2), np.float64)
        for i, name in enumerate(sub):
            p = prepared[name]
            n = len(p["train"])
            train[i, :n] = np.log(p["train"])
            train[i, n:] = train[i, 0]          # benign pad location
            train_w[i, :n] = 1.0
            data[i, :len(p["data"])] = np.log(p["data"])
        u = torch.stack([torch.rand((lmode, R), device=device,
                                    generator=residue_generator(
                                        cfg, name, 0, device))
                         for name in sub])
        labels, _ = fit_predict_batched(
            torch.as_tensor(train, dtype=torch.float32, device=device),
            torch.as_tensor(train_w, device=device),
            torch.as_tensor(data, dtype=torch.float32, device=device),
            lmode, u, cfg.gmm_max_iter, cfg.gmm_tol)
        labels = labels.cpu().numpy()
        for i, name in enumerate(sub):
            p = prepared[name]
            p["labels"] = labels[i, :len(p["data"])].astype(np.int32)


def process_residues_batched(items: Dict[str, tuple], cfg: GibbsConfig,
                             chain=0, device=None
                             ) -> Dict[str, ClusterResult]:
    """Post-process many residues' chains in bucketed batches.

    Args:
        items: {residue: (mcweights (chains, S, K), mcrates, values (V,),
            counts (V,))} — the sampler's outputs and each residue's
            deduplicated times.
        chain: chain index or 'pooled' (cf. Gibbs.process_gibbs).
        device: where the GMM and votes run (default: the CUDA device if
            there is one, else the CPU).

    Returns:
        {residue: ClusterResult} (sorted labels, pindicator, presorts).
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    b = cfg.burnin_samples
    prepared = {}
    for name, (mcw, mcr, values, counts) in items.items():
        W, R = select_chain(np.asarray(mcw), np.asarray(mcr), chain, b)
        if b >= len(W):
            raise ValueError(
                f"burn-in discards all samples for {name} ({b} thinned "
                f"burn-in vs {len(W)} collected)")
        W, R = W[b:], R[b:]
        wcutoff = cfg.wcutoff(int(np.asarray(counts).sum()))
        lmode = select_lmode(component_counts(W, wcutoff))
        data, inds, train = gather_cluster_data(W, R, wcutoff, lmode)
        prepared[name] = dict(W=W, R=R, values=np.asarray(values),
                              counts=np.asarray(counts), lmode=lmode,
                              data=data, inds=inds, train=train)

    buckets: Dict[tuple, list] = {}
    for name, p in prepared.items():
        key = (p["lmode"], _pad_size(len(p["train"])),
               _pad_size(len(p["data"])))
        buckets.setdefault(key, []).append(name)
    for (lmode, Mt_p, M_p), names in buckets.items():
        _gmm_bucket(prepared, names, lmode, Mt_p, M_p, cfg, device)

    vbuckets: Dict[tuple, list] = {}
    for name, p in prepared.items():
        vbuckets.setdefault((_pad_size(len(p["values"])), p["W"].shape),
                            []).append(name)
    results: Dict[str, ClusterResult] = {}
    for (V_p, (S, K)), names in vbuckets.items():
        for part in _chunks(len(names), min(S * V_p * K, VOTE_CHUNK),
                            _VOTE_BATCH):
            sub = names[part]
            Bk = len(sub)
            Wb = np.empty((Bk, S, K), np.float32)
            Rb = np.empty((Bk, S, K), np.float32)
            Vb = np.ones((Bk, V_p), np.float32)
            Cb = np.zeros((Bk, V_p), np.float32)
            Lb = np.empty((Bk, S, K), np.int64)
            for i, name in enumerate(sub):
                p = prepared[name]
                Wb[i], Rb[i] = p["W"], p["R"]
                Vb[i, :len(p["values"])] = p["values"]
                Cb[i, :len(p["counts"])] = p["counts"]
                Lb[i] = _label_matrix(p["inds"], p["labels"], (S, K))
            gens = [residue_generator(cfg, name, 1, device) for name in sub]
            tens = [torch.as_tensor(x, device=device)
                    for x in (Wb, Rb, Vb, Cb, Lb)]
            votes = votes_bucket(*tens, gens).cpu().numpy()
            for i, name in enumerate(sub):
                p = prepared[name]
                v = votes[i, :len(p["values"]), :p["lmode"]]
                denom = v.sum(axis=1, keepdims=True)
                res = ClusterResult(lmode=p["lmode"], labels=p["labels"],
                                    inds=p["inds"], data=p["data"])
                res.pindicator_values = v / np.maximum(denom, 1e-30)
                results[name] = sort_labels_by_rate(res, cfg.noise_cutoff)
    return {name: results[name] for name in items}
