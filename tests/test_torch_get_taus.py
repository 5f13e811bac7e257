"""``ProcessProtein.get_taus`` takes a saved tau from the result's
``_meta`` and ``tau`` alone and rebuilds a ``Gibbs`` only where the file
holds none. On a results tree of every kind of residue (tau saved, no tau
saved, all noise with and without a saved tau, a reference ``.pkl``, no
result) the (taus, bars) are bitwise those of the full ``Gibbs.load``
path, and ``write_data``'s table is unchanged."""

import os
import shutil

import numpy as np
import pytest
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.postprocess.tau import AllNoiseError
from basicrta_torch.protein import driver
from basicrta_torch.protein.driver import ProcessProtein
from basicrta_torch.sampler.gibbs import Gibbs
from tests.test_torch_legacy import _gibbs_pickle


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small eager steps: with torch's intra-op threads, each step waits
    for threads that the suite's other workers keep busy. One thread
    here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NITER = 590         # the reference pickle's
CFG = GibbsConfig(ncomp=5, niter=NITER, g=10, burnin=100, gmm_n_init=4,
                  n_chains=2)
# label -> (tau saved, all noise)
KINDS = {"X10": (True, False), "X20": (False, False), "X30": (True, True),
         "X40": (False, True)}


def _chains(seed, S=60, K=5):
    """Two chains of a fast (w 0.8, r 2) and a slow (w 0.2) component,
    the rest below the weight cutoff."""
    rng = np.random.default_rng(seed)
    W = np.full((2, S, K), 1e-6)
    R = rng.uniform(0.5, 5.0, (2, S, K))
    W[..., 0] = rng.normal(0.78, 0.01, (2, S))
    W[..., 1] = rng.normal(0.2, 0.01, (2, S))
    R[..., 0] = rng.lognormal(np.log(2.0), 0.03, (2, S))
    R[..., 1] = rng.lognormal(np.log(0.1 + 0.05 * seed), 0.05, (2, S))
    return W.astype(np.float32), R.astype(np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("taus")
    rng = np.random.default_rng(3)
    for i, (label, (saved, noise)) in enumerate(KINDS.items()):
        times = discretize_times(simulate_hyperexp(
            800, [0.85, 0.15], [2.0, 0.1], rng), 0.1)
        g = Gibbs(times, residue=label, cutoff=7.0, cfg=CFG, root=str(root))
        g.mcweights, g.mcrates = _chains(i)
        g.process_gibbs(save=False, device="cpu")
        if noise:
            g.processed.pindicator_values = np.zeros_like(
                g.processed.pindicator_values)
        if saved:
            try:
                g.estimate_tau()
            except AllNoiseError:
                g.tau = (0.0, 0.0, 0.0)
        g.save()
    d = root / "basicrta-7.0" / "W50"
    d.mkdir()
    _gibbs_pickle(d / f"gibbs_{NITER}.pkl", rng, label="W50")
    (root / "basicrta-7.0" / "X60").mkdir()      # no result
    return root


def _run(tree, dst, monkeypatch, full):
    """(taus, bars, write_data's table, the paths Gibbs.load read) on a
    copy of ``tree``; ``full`` takes the full load for every residue."""
    root = str(shutil.copytree(tree, dst))
    loaded = []
    load = Gibbs.load

    def counted(path):
        loaded.append(os.path.basename(os.path.dirname(path)))
        return load(path)

    with monkeypatch.context() as m:
        m.setattr(Gibbs, "load", staticmethod(counted))
        if full:
            m.setattr(driver, "_saved_tau", lambda path: None)
        pp = ProcessProtein(cfg=GibbsConfig(niter=NITER), cutoff=7.0,
                            root=root, device="cpu")
        taus, bars = pp.get_taus()
        table = np.load(pp.write_data())
    return taus, bars, table, loaded


def test_get_taus_equals_the_full_load(tree, tmp_path, monkeypatch):
    fast = _run(tree, tmp_path / "fast", monkeypatch, full=False)
    full = _run(tree, tmp_path / "full", monkeypatch, full=True)
    for a, b in zip(fast[:3], full[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    taus, bars, table, loaded = fast
    # the residues: X10 X20 X30 X40 W50 X60, in resid order
    assert list(table[:, 0]) == [10, 20, 30, 40, 50, 60]
    assert taus[0] > 0 and taus[1] > 0 and taus[4] > 0
    np.testing.assert_array_equal(taus[[2, 3, 5]], 0.0)
    np.testing.assert_array_equal(bars[:, [2, 3, 5]], 0.0)
    # the full path loads every result twice (get_taus and write_data);
    # the fast one only those that hold no tau
    assert sorted(loaded) == ["W50", "W50", "X20", "X20", "X40", "X40"]
    assert sorted(full[3]) == sorted(2 * ["X10", "X20", "X30", "X40",
                                          "W50"])


@pytest.mark.parametrize("label", ["X10", "X20", "X30", "X40", "W50"])
def test_saved_tau_reads_what_gibbs_load_holds(tree, label):
    d = tree / "basicrta-7.0" / label
    (path,) = [str(p) for p in d.iterdir() if p.name.startswith("gibbs_")
               and p.suffix in (".npz", ".pkl")]
    got = driver._saved_tau(path)
    tau = Gibbs.load(path).tau
    if tau is None:
        assert got is None
    else:
        assert KINDS[label][0]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(tau))
        assert got == list(tau)
