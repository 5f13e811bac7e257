"""Small host-side statistics of residence times (numpy).

The port's own copies of the JAX package's ``ops.surv`` helpers that the
port calls: the timestep of a set of residence times, the empirical
survival function and its bins, the empirical credible interval, error-bar
offsets, the count of distinct rates, the rounding precision of a
timestep, event frame ranges, and the synthetic hyperexponential data of
the tests and the smoke run (reference util.py:78-120, 508-520, 596-620,
653-660 and gibbs.py:146-153).
"""

from __future__ import annotations

import numpy as np


def infer_timestep(times: np.ndarray) -> float:
    """Smallest nonzero gap between sorted residence times, or the
    minimum time when all values are identical."""
    ts_sorted = np.sort(np.asarray(times))
    diffs = np.diff(ts_sorted)
    nonzero = diffs[diffs != 0]
    if nonzero.size:
        return float(nonzero.min())
    return float(ts_sorted.min())


def survival_bins(x: np.ndarray, ts: float) -> np.ndarray:
    """Histogram bin edges ``ts, 2*ts, ..., (floor(max/ts)+2)*ts``, so
    every discrete residence time falls in its own bin."""
    x = np.asarray(x)
    return np.arange(1, int(x.max() // ts) + 3) * ts


def survival_function(x: np.ndarray, ts: float):
    """Empirical survival function ``(t, s)`` of residence times on the
    timestep grid, with a leading (0, 1) point and empty bins dropped."""
    x = np.asarray(x, dtype=np.float64)
    counts, edges = np.histogram(x, bins=survival_bins(x, ts))
    nonzero = counts != 0
    t = edges[:-1][nonzero]
    y = np.cumsum(counts[nonzero]).astype(np.float64)
    t = np.insert(t, 0, 0.0)
    y = np.insert(y, 0, 0.0)
    y /= y[-1]
    return t, 1.0 - y


def empirical_ci(data: np.ndarray, percentage: float = 95.0):
    """Empirical-CDF credible interval ``[lo, hi]``: lo the largest sorted
    value whose CDF is <= (100 - p) / 200, hi the smallest whose CDF is >=
    the upper quantile, the data range for tiny samples."""
    ds = np.sort(np.asarray(data))
    n = ds.size
    perc = np.arange(1, n + 1) / n
    lower = (100.0 - percentage) / 200.0
    upper = (percentage + (100.0 - percentage) / 2.0) / 100.0
    lo_idx = np.where(perc <= lower)[0]
    hi_idx = np.where(perc >= upper)[0]
    lo = ds[lo_idx[-1]] if lo_idx.size else ds[0]
    hi = ds[hi_idx[0]] if hi_idx.size else ds[-1]
    return [float(lo), float(hi)]


def ci_bars(tau: np.ndarray) -> np.ndarray:
    """Rows ``[lo, max, hi]`` -> errorbar offsets
    ``[[max - lo, ...], [hi - max, ...]]``."""
    tau = np.asarray(tau)
    return np.array([tau[:, 1] - tau[:, 0], tau[:, 2] - tau[:, 1]])


def decimals_of(ts: float) -> int:
    """Rounding precision that preserves multiples of the timestep: the
    count of decimal digits for fractional timesteps (0.1 -> 1, 0.25 -> 2)
    and minus the count of trailing zeros for integral ones (1.0 -> 0,
    10.0 -> -1), from the exact decimal exponent."""
    from decimal import Decimal
    return -Decimal(str(float(ts))).normalize().as_tuple().exponent


def start_stop_frames(start_times: np.ndarray, durations: np.ndarray,
                      ts: float):
    """Inclusive frame ranges ``(first, last)`` of events: the quotients
    of times rounded to the timestep's decimals by ``ts``, rounded to the
    nearest integer (0.3 / 0.1 is 2.999..., which truncation would make
    2)."""
    dec = decimals_of(ts)
    nframes = np.rint(np.round(durations, dec) / ts).astype(np.int64)
    first = np.rint(np.round(start_times, dec) / ts).astype(np.int64)
    return first, first + nframes - 1


def simulate_hyperexp(n: int, weights, rates, rng=None,
                      sort: bool = True) -> np.ndarray:
    """``n`` draws from a hyperexponential mixture: a component by the
    weights, then an exponential waiting time at its rate by inverse CDF."""
    rng = np.random.default_rng() if rng is None else rng
    weights = np.asarray(weights, dtype=np.float64)
    rates = np.asarray(rates, dtype=np.float64)
    comp = rng.choice(len(weights), size=int(n), p=weights / weights.sum())
    x = -np.log(rng.random(int(n))) / rates[comp]
    if sort:
        x.sort()
    return x


def unique_rate_count(ncomp: int, mcrates: np.ndarray) -> int:
    """Components with statistically distinct rates: over the last 10% of
    samples, a component whose mean rate lies within one standard
    deviation of another's is degenerate."""
    tail = mcrates[len(mcrates) * 9 // 10:]
    means, stds = tail.mean(axis=0), tail.std(axis=0)
    lb, ub = means - stds, means + stds
    overlap = (means[:, None] < ub[None, :]) & (means[:, None] > lb[None, :])
    sums = overlap.sum(axis=0)
    return int(ncomp - np.count_nonzero(sums != 1))


def discretize_times(times: np.ndarray, ts: float) -> np.ndarray:
    """Snap continuous times to the timestep grid (>= ts), so synthetic
    data share the duplicate-heavy structure of real residence times."""
    times = np.asarray(times, dtype=np.float64)
    k = np.maximum(np.round(times / ts), 1.0)
    return k * ts
