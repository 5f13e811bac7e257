"""The synthetic all-residue protein workload of the benchmarks.

The port's copy of ``bench.py``'s ``make_workload``: one flagship residue
at the bundled W313 dataset's size (446,605 events) and residues whose
event counts are log-uniform in 10^2..10^5.3, each a hyperexponential
mixture with the W313 posterior's shape, discretised to 0.1 ns. The same
seed gives the same residence times as ``bench.py``.
"""

from __future__ import annotations

import numpy as np

W313_EVENTS = 446_605
N_RESIDUES = 300


def simulate_hyperexp(n, weights, rates, rng):
    """Sorted hyperexponential draws: a component by the weights, then an
    exponential waiting time at its rate."""
    weights = np.asarray(weights, np.float64)
    rates = np.asarray(rates, np.float64)
    comp = rng.choice(len(weights), size=int(n), p=weights / weights.sum())
    x = -np.log(rng.random(int(n))) / rates[comp]
    x.sort()
    return x


def discretize(times, ts=0.1):
    """Round to multiples of the timestep ``ts``, at least one step."""
    return np.maximum(np.round(np.asarray(times) / ts), 1.0) * ts


def make_workload(n_residues=N_RESIDUES, seed=0, flagship=W313_EVENTS):
    """{residue index: residence times}: the flagship residue (``flagship``
    events) and ``n_residues - 1`` log-uniform 10^2..10^5.3-event ones."""
    rng = np.random.default_rng(seed)
    w = np.array([0.87, 0.09, 0.03, 0.009, 0.001])
    r = np.array([4.7, 1.3, 0.33, 0.06, 0.009])
    sizes = np.concatenate([
        [flagship],
        (10 ** rng.uniform(2.0, 5.3, n_residues - 1)).astype(int)])
    residues = {}
    for i, n in enumerate(sizes):
        scale = rng.uniform(0.7, 1.5)
        residues[i] = discretize(simulate_hyperexp(int(n), w, r * scale,
                                                   rng))
    return residues
