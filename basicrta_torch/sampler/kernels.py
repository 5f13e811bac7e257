r"""The Gibbs sweeps of the exponential mixture model as plain torch ops.

Port of ``basicrta_tpu.sampler.kernels``: the chain carry, the
deterministic log-spaced initialisation, the collapse of residence times
to (unique value, multiplicity) pairs and their multiplicity tiers, and
the two reference formulations of a sweep (reference gibbs.py:191-217),
written apart from the fused kernels of ``csrc/sweep.cu``:

- **dense**: one categorical indicator per event, then the sufficient
  statistics ``N_k`` and ``T_k = sum x_i [s_i = k]`` and the conjugate
  draws ``w ~ Dirichlet(alpha + N)``, ``r_k ~ Gamma(a + N_k, b + T_k)``;
- **collapsed**: events of equal value have equal responsibility rows, so
  the counts of each unique value are ``m_v ~ Multinomial(c_v, z_v)`` and
  (N, T) = (sum_v m_v, sum_v v m_v): the dense chain in law, at ~N/V less
  work a sweep.

Every function batches over leading axes (chains, or the lanes of a
bucket) and draws from an explicit ``torch.Generator`` on the tensors'
device; lanes that share a generator are independent in law, not draw
for draw. Computation is f32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops import random as btrandom


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


def _log_responsibilities(state: MixtureState,
                          values: torch.Tensor) -> torch.Tensor:
    """Unnormalised log responsibilities, shape (..., V, K)."""
    logw = torch.log(state.weights)[..., None, :]
    logr = torch.log(state.rates)[..., None, :]
    return logw + logr - values[..., :, None] * state.rates[..., None, :]


def _conjugate_update(generator: torch.Generator, Ns: torch.Tensor,
                      Ts: torch.Tensor, alpha: float, a: float,
                      b: float) -> MixtureState:
    """Dirichlet/Gamma conjugate posterior draws (reference
    gibbs.py:210-211)."""
    weights = btrandom.dirichlet(alpha + Ns, generator)
    rates = btrandom.gamma(a + Ns, generator) / (b + Ts)
    return MixtureState(weights, rates)


def _suff_stats(values: torch.Tensor, m: torch.Tensor):
    """(N_k, T_k) of per-value component counts m (..., V, K). T_k is a
    sum reduction, not a matmul: cuBLAS may pick its algorithm by what
    else ran, and a chain must not depend on that (exact resume)."""
    return m.sum(-2), (values[..., :, None] * m).sum(-2)


def multinomial_counts(n: torch.Tensor, probs: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """Exact batched multinomial counts ``m_v ~ Multinomial(n_v,
    probs_v)`` (the conditional-binomial chain of ``ops.random``)."""
    return btrandom.multinomial(n, probs, generator)


def dense_sweep(generator: torch.Generator, state: MixtureState,
                times: torch.Tensor, mask: Optional[torch.Tensor],
                cfg: GibbsConfig, return_indicator: bool = False):
    """One Gibbs sweep over raw per-event times (..., N): an inverse-CDF
    categorical indicator per event. ``mask`` (optional, (..., N) 0/1)
    keeps padded events out of the sufficient statistics."""
    probs = torch.softmax(_log_responsibilities(state, times), -1)
    u = torch.rand(probs.shape[:-1], generator=generator, dtype=times.dtype,
                   device=times.device)
    # the CDF over K with the events innermost: a scan along a 15-long
    # innermost axis of 446,605 rows took 2.6 ms a sweep on the card
    cdf = torch.cumsum(probs.transpose(-1, -2), -2)             # (..., K, N)
    s = torch.clamp_max((u[..., None, :] > cdf).sum(-2), cfg.ncomp - 1)
    onehot = probs.new_zeros(probs.shape).scatter_(
        -1, s[..., None], 1.0 if mask is None
        else mask.expand(s.shape)[..., None].to(probs.dtype))
    Ns, Ts = _suff_stats(times, onehot)
    new_state = _conjugate_update(generator, Ns, Ts, cfg.alpha_eff,
                                  cfg.gamma_shape, cfg.gamma_rate)
    return new_state, (s.to(torch.uint8) if return_indicator else None)


# Multiplicity bound of the middle tier: values with counts <= this take
# the bounded sampler (the kernels' 17-step inversion) instead of the
# general one.
SMALL_NMAX = 16


def _tiered_multinomial(generator: torch.Generator, counts: torch.Tensor,
                        probs: torch.Tensor,
                        tiers: Optional[Tuple[int, int]]) -> torch.Tensor:
    """Multinomial counts over the value axis in three exact tiers. With
    ``tiers = (head_end, single_start)`` and value columns sorted by
    multiplicity descending: columns [0, head_end) take the general
    binomial chain, [head_end, single_start) (counts <= SMALL_NMAX) the
    bounded sampler, and [single_start, V) (counts in {0, 1}) one
    categorical draw."""
    if tiers is None:
        return btrandom.multinomial(counts, probs, generator)
    head_end, single_start = tiers
    V = counts.shape[-1]
    parts = []
    if head_end > 0:
        parts.append(btrandom.multinomial(
            counts[..., :head_end], probs[..., :head_end, :], generator))
    if single_start > head_end:
        parts.append(btrandom.multinomial_small(
            counts[..., head_end:single_start],
            probs[..., head_end:single_start, :], SMALL_NMAX, generator))
    if V > single_start:
        parts.append(btrandom.multinomial_single(
            counts[..., single_start:], probs[..., single_start:, :],
            generator))
    return torch.cat(parts, -2)


def collapsed_sweep(generator: torch.Generator, state: MixtureState,
                    values: torch.Tensor, counts: torch.Tensor,
                    cfg: GibbsConfig, return_counts: bool = False,
                    tiers: Optional[Tuple[int, int]] = None):
    """One Gibbs sweep over (value, multiplicity) pairs (..., V); padding
    has count 0 and draws nothing. ``tiers`` needs the value columns
    sorted by multiplicity descending (:func:`compute_tiers`)."""
    probs = torch.softmax(_log_responsibilities(state, values), -1)
    # chains that share one value axis draw their own counts
    counts = counts.expand(probs.shape[:-1]).contiguous()
    m = _tiered_multinomial(generator, counts, probs, tiers)
    Ns, Ts = _suff_stats(values, m)
    new_state = _conjugate_update(generator, Ns, Ts, cfg.alpha_eff,
                                  cfg.gamma_shape, cfg.gamma_rate)
    return new_state, (m if return_counts else None)


def _thinned_scan(sweep_fn, generator: torch.Generator, state: MixtureState,
                  g: int, n_blocks: int):
    """``n_blocks * g`` sweeps, the state kept after every g-th (reference
    gibbs.py:214-217). Returns (state, W, R), W and R (..., n_blocks, K)."""
    W = state.weights.new_empty(state.weights.shape[:-1]
                                + (n_blocks, state.weights.shape[-1]))
    R = torch.empty_like(W)
    for blk in range(n_blocks):
        for _ in range(g):
            state = sweep_fn(generator, state)
        W[..., blk, :] = state.weights
        R[..., blk, :] = state.rates
    return state, W, R


def run_chains(generator: torch.Generator, times_or_values: torch.Tensor,
               counts_or_mask: Optional[torch.Tensor], cfg: GibbsConfig,
               mode: str = "collapsed", n_chains: int = 1,
               tiers: Optional[Tuple[int, int]] = None):
    """``n_chains`` chains from the initial state, run together as one
    batched program (the JAX package vmaps them).

    Args:
        times_or_values: (N,) raw times for ``mode='dense'`` or (V,)
            unique values for ``mode='collapsed'``.
        counts_or_mask: (V,) multiplicities (0 marks padding) for
            collapsed; an optional (N,) 0/1 mask for dense.
        tiers: multiplicity tiers (:func:`compute_tiers`); they need the
            values in count-descending order.

    Returns:
        (mcweights, mcrates), each (n_chains, niter // g, ncomp).
    """
    if mode == "collapsed":
        def sweep(gen, st):
            return collapsed_sweep(gen, st, times_or_values, counts_or_mask,
                                   cfg, tiers=tiers)[0]
    elif mode == "dense":
        def sweep(gen, st):
            return dense_sweep(gen, st, times_or_values, counts_or_mask,
                               cfg)[0]
    else:
        raise ValueError(f"unknown mode {mode!r}; use 'collapsed' or "
                         "'dense'")
    st0 = init_mixture_params(cfg.ncomp, device=times_or_values.device)
    state = MixtureState(st0.weights.repeat(n_chains, 1),
                         st0.rates.repeat(n_chains, 1))
    _, W, R = _thinned_scan(sweep, generator, state, cfg.g, cfg.n_samples)
    return W, R


def run_chain(generator: torch.Generator, times_or_values: torch.Tensor,
              counts_or_mask: Optional[torch.Tensor], cfg: GibbsConfig,
              mode: str = "collapsed",
              tiers: Optional[Tuple[int, int]] = None):
    """One chain (:func:`run_chains` with one chain): (mcweights, mcrates),
    each (niter // g, ncomp)."""
    W, R = run_chains(generator, times_or_values, counts_or_mask, cfg, mode,
                      1, tiers)
    return W[0], R[0]


def sample_indicator_counts(generator: torch.Generator,
                            mcweights: torch.Tensor, mcrates: torch.Tensor,
                            values: torch.Tensor, counts: torch.Tensor,
                            cfg: GibbsConfig, rao: bool = False):
    """Per-value component counts for each saved sample (S, K): fresh
    conditional draws of the indicator (reference gibbs.py:321-334
    ``_sample_indicator``), or with ``rao`` their expectation ``c_v z_vk``.

    Returns:
        (S, V, K) float counts.
    """
    probs = torch.softmax(_log_responsibilities(
        MixtureState(mcweights, mcrates), values), -1)
    c = counts.expand(probs.shape[:-1])
    if rao:
        return c[..., None] * probs
    return multinomial_counts(c.contiguous(), probs, generator)


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
