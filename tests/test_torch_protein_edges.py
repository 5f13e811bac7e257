"""Failure detection and absent results in the port's protein driver
against the JAX package's: ``tests/test_aux.py::TestFailureDetection``,
``tests/test_protein.py::test_missing_residue_gets_zero_tau`` and
``tests/test_cli.py::test_cli_unknown_resid``.

Host code over one results tree: both packages list the same missing
residues (a directory with no result and no ``.dataset_too_small``
sentinel), give a missing residue τ = 0 with the others equal, and treat
``gibbs --resid`` of a residue not in the table as a no-op."""

import os

import numpy as np
import pytest

from basicrta_tpu import cli as jcli
from basicrta_tpu.config import GibbsConfig as JGibbsConfig
from basicrta_tpu.protein.driver import ProcessProtein as JProcessProtein

from basicrta_torch import cli
from basicrta_torch.config import GibbsConfig
from basicrta_torch.contacts.records import ContactEvents, ContactMeta
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.protein.driver import ProcessProtein
from basicrta_torch.sampler.gibbs import Gibbs


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(root, niter):
    return (ProcessProtein(cfg=GibbsConfig(niter=niter), cutoff=7.0,
                           root=root),
            JProcessProtein(cfg=JGibbsConfig(niter=niter), cutoff=7.0,
                            root=root))


def test_missing_and_skipped(tmp_path):
    base = tmp_path / "basicrta-7.0"
    (base / "W10").mkdir(parents=True)
    np.savez(base / "W10" / "gibbs_100.npz", x=1)   # done
    (base / "A11").mkdir()                           # missing
    (base / "G12").mkdir()                           # skipped
    (base / "G12" / ".dataset_too_small").touch()
    (base / "notes").mkdir()                         # not a residue
    mine, theirs = _pair(str(tmp_path), 100)
    assert mine.collect_results() == theirs.collect_results()
    assert mine.missing_residues() == theirs.missing_residues() == ["A11"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One residue sampled by the port (torch engine) and processed, plus
    an empty residue directory (a run that never finished)."""
    root = str(tmp_path_factory.mktemp("protein_edges"))
    x = discretize_times(simulate_hyperexp(
        1500, [0.8, 0.2], [3.0, 0.05], np.random.default_rng(6)), 0.1)
    cfg = GibbsConfig(ncomp=4, niter=400, g=10, burnin=100, gmm_n_init=4,
                      seed=1)
    g = Gibbs(x, residue="X10", cutoff=7.0, cfg=cfg, root=root)
    g.run(engine="torch", save=False)
    g.process_gibbs(device="cpu", save=False)
    g.estimate_tau()
    g.save()
    os.makedirs(os.path.join(root, "basicrta-7.0", "G12"))
    return root


def test_missing_residue_gets_zero_tau(tree):
    mine, theirs = _pair(tree, 400)
    mine.collect_results()
    theirs.collect_results()
    assert mine.residues["G12"] is None and theirs.residues["G12"] is None
    taus, bars = mine.get_taus()
    jtaus, jbars = theirs.get_taus()
    np.testing.assert_array_equal(taus, jtaus)
    np.testing.assert_array_equal(bars, jbars)
    assert taus[-1] == 0.0 and taus[0] > 0
    assert mine.missing_residues() == theirs.missing_residues() == ["G12"]


def test_cli_unknown_resid_is_a_no_op(tmp_path, monkeypatch):
    x = discretize_times(simulate_hyperexp(
        300, [0.8, 0.2], [2.0, 0.1], np.random.default_rng(3)), 0.1)
    s1 = np.full(len(x), 7, np.int32)
    ev = ContactEvents(s1, np.full(len(x), 100, np.int32),
                       np.arange(len(x), dtype=float), x,
                       ContactMeta(ts=0.1, cutoff=7.0))
    for name, main, extra in (("torch", cli.main, ["--engine", "torch"]),
                              ("jax", jcli.main, [])):
        d = tmp_path / name
        d.mkdir()
        ev.save(str(d / "contacts_7.0.npz"))
        monkeypatch.chdir(d)
        main(["gibbs", "--contacts", "contacts_7.0.npz", "--niter", "300",
              "--ncomp", "3", "--resid", "999", *extra])
        base = d / "basicrta-7.0"
        assert not base.exists() or not any(
            (p / "gibbs_300.npz").exists() for p in base.iterdir())
