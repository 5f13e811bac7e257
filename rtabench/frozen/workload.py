"""Frozen copy of the port's synthetic W313 dataset.

Copied from ``basicrta_torch.datafiles.synthetic_times`` (and the two
functions of ``basicrta_torch.ops.surv`` it draws with) so that a later
change to the program cannot move the benchmark's inputs;
``rtabench/tests`` holds the copy to the port's output bit for bit.
The mixture is not fixed here: the configuration states it.
"""

from __future__ import annotations

import numpy as np


def simulate_hyperexp(n, weights, rates, rng=None, sort=True):
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


def discretize(times, ts=0.1):
    """Round to multiples of the timestep ``ts``, at least one step."""
    times = np.asarray(times, dtype=np.float64)
    k = np.maximum(np.round(times / ts), 1.0)
    return k * ts


def synthetic_times(dataset):
    """The residence times of a configuration's ``dataset`` entry
    (``n_events``, ``timestep_ns``, ``seed``, ``weights``,
    ``rates_per_ns``), drawn as ``synthetic_times`` draws them."""
    rng = np.random.default_rng(dataset["seed"])
    return discretize(simulate_hyperexp(dataset["n_events"],
                                        dataset["weights"],
                                        dataset["rates_per_ns"], rng),
                      dataset["timestep_ns"])
