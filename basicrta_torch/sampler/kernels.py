"""Chain state, initialisation and the host-side value layout.

Ports of ``basicrta_tpu.sampler.kernels``: the chain carry, the
deterministic log-spaced initialisation, the collapse of residence times
to (unique value, multiplicity) pairs, and the multiplicity tiers the
fused sweep kernel samples with different exact binomial samplers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class MixtureState(NamedTuple):
    """Carry of the Gibbs chain."""
    weights: torch.Tensor  # (..., K) f32
    rates: torch.Tensor    # (..., K) f32


def init_mixture_params(ncomp: int, device=None) -> MixtureState:
    """Deterministic log-spaced initialisation: rates 0.5 * 10^[1 ..
    -(K-2)] descending, weights a normalised geometric ladder 9 *
    10^-(1..K) (reference gibbs.py:186-188)."""
    inrates = 0.5 * 10.0 ** np.arange(-ncomp + 2, 2, dtype=np.float64)
    tmpw = 9.0 * 10.0 ** (-np.arange(1, ncomp + 1, dtype=np.float64))
    weights = tmpw / tmpw.sum()
    rates = inrates[::-1].copy()
    return MixtureState(
        torch.as_tensor(weights, dtype=torch.float32, device=device),
        torch.as_tensor(rates, dtype=torch.float32, device=device))


def dedup_times(times: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse residence times to (unique values, multiplicities)."""
    values, counts = np.unique(np.asarray(times, dtype=np.float64),
                               return_counts=True)
    return values, counts


# Multiplicity bound of the middle tier: values with counts <= this use the
# complete 17-step inversion sampler instead of inversion + BTRS.
SMALL_NMAX = 16


def compute_tiers(counts: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Sort value columns by multiplicity descending and return the tier
    boundaries (head_end, single_start); for (B, V) input they are maxima
    over lanes.

    Returns:
        (order, (head_end, single_start)): ``order`` sorts the value axis.
    """
    counts = np.asarray(counts)
    order = np.argsort(-counts, axis=-1, kind="stable")
    sorted_counts = np.take_along_axis(counts, order, axis=-1)
    flat = sorted_counts.reshape(-1, sorted_counts.shape[-1])
    head_end = int(np.max(np.count_nonzero(flat > SMALL_NMAX, axis=-1)))
    single_start = int(np.max(np.count_nonzero(flat > 1, axis=-1)))
    single_start = max(single_start, head_end)
    return order, (head_end, single_start)
