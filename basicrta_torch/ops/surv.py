"""Small host-side statistics of residence times (numpy).

The port's own copies of the JAX package's ``ops.surv`` helpers that the
port calls: the timestep of a set of residence times, the empirical
credible interval, and error-bar offsets (reference util.py:78-99 and
gibbs.py:146-153).
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
