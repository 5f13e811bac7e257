"""Example datasets for documentation, quick starts and validation.

Port of ``basicrta_tpu.datafiles``. The reference ships a real
446,605-event residence-time dataset as ``basicrta.tests.datafiles.times``
(reference tests/datafiles.py:20-29); this module generates an equivalent
synthetic one on demand (same scale, a W313-posterior-like mixture, the
same timestep grid), bit for bit the JAX package's for the same seed.
"""

from __future__ import annotations

import os

import numpy as np

from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp

# W313-posterior-like mixture (fit to the bundled reference dataset)
_WEIGHTS = np.array([0.87, 0.09, 0.03, 0.009, 0.001])
_RATES = np.array([4.7, 1.3, 0.33, 0.06, 0.009])


def synthetic_times(n: int = 446_605, ts: float = 0.1,
                    seed: int = 0) -> np.ndarray:
    """Synthetic residence times matching the bundled W313 dataset's scale
    and computational shape (n events, timestep grid, multiplicity skew)."""
    rng = np.random.default_rng(seed)
    return discretize_times(simulate_hyperexp(n, _WEIGHTS, _RATES, rng), ts)


def real_times_path():
    """Path to the reference's bundled 446,605-event W313 dataset when one
    is available, else None: the ``BASICRTA_TIMES_NPY`` environment
    variable, then an installed ``basicrta`` package's test data."""
    cands = [os.environ.get("BASICRTA_TIMES_NPY")]
    try:
        import basicrta.tests.datafiles as _rd
        cands.append(getattr(_rd, "times", None))
    except ImportError:
        pass
    for c in cands:
        if c and isinstance(c, str) and os.path.exists(c):
            return c
    return None


def load_times(prefer_real: bool = True, n: int = 446_605,
               seed: int = 0) -> np.ndarray:
    """The W313-scale example dataset: the real bundled file when present
    (and ``prefer_real``), else the synthetic equivalent."""
    if prefer_real:
        path = real_times_path()
        if path is not None:
            return np.load(path)
    return synthetic_times(n, seed=seed)


def __getattr__(name):
    """``times``: the module-level example dataset, analogous to
    ``basicrta.tests.datafiles.times`` (made on first access)."""
    if name == "times":
        return synthetic_times(50_000)
    raise AttributeError(name)
