"""The frozen copies reproduce the port's generator and work counts."""

import json
import os

import numpy as np
import pytest

from basicrta_torch import datafiles
from basicrta_torch.sampler import cuda_sweep
from rtabench import harness
from rtabench.frozen import work
from rtabench.frozen import workload as wl


def _dataset(**kw):
    with open(os.path.join(harness.PKG, "configs", "w313.json")) as f:
        return {**json.load(f)["dataset"], **kw}


@pytest.mark.parametrize("seed,n", [(0, 446_605), (3, 5000)])
def test_synthetic_times_bitwise(seed, n):
    ours = wl.synthetic_times(_dataset(seed=seed, n_events=n))
    theirs = datafiles.synthetic_times(n, seed=seed)
    assert ours.dtype == theirs.dtype
    assert np.array_equal(ours, theirs)


def test_the_configured_law_is_the_ports():
    d = _dataset()
    assert d["weights"] == datafiles._WEIGHTS.tolist()
    assert d["rates_per_ns"] == datafiles._RATES.tolist()
    assert d["n_events"] == 446_605 and d["timestep_ns"] == 0.1
    assert d["seed"] == 0


@pytest.mark.parametrize("B,V,pack,tiers,K,phys", [
    (2, 1024, 1, (40, 300), 15, None),
    (300, 128, 1, (3, 20), 15, None),
    (17, 256, 4, (10, 50), 15, None),
    (9, 128, 8, (0, 16), 5, None),
    (40, 0, 7, (0, 0), 15, (6, 2, 4)),
    (40, 0, 9, (0, 0), 15, (3, 1, 2, 24)),
])
def test_static_count_matches_the_port(B, V, pack, tiers, K, phys):
    assert (work.transcendentals_per_sweep(B, V, pack, tiers, K, phys)
            == cuda_sweep.transcendentals_per_sweep(B, V, pack, tiers, K,
                                                    phys))


def test_lane_count_by_hand():
    # lane a: 3 unique times, multiplicities 40 (head), 5 (small), 1
    # lane b: 2 unique times, multiplicities 1, 1 (singletons only)
    K = 4
    conj = 2 * K * (8 * 3 + 2)
    a = K * 3 + (K - 1) * (1 * 37 + 1 * 2) + conj
    b = K * 2 + conj
    assert work.lane_transcendentals([40, 5, 1, 0, 0], K) == a == 337
    assert work.lane_transcendentals([1, 1], K) == b == 216
    # one full 128-column unpacked lane of head columns, which the
    # reference layout pads to 8 lanes, is the static count over 8
    counts = np.full(128, 17)
    assert (8 * work.lane_transcendentals(counts, 15)
            == work.transcendentals_per_sweep(1, 128, 1, (128, 128), 15))
    assert work.sfu_peak(1980.0) == 16 * 132 * 1980e6
