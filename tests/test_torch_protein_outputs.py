"""What ``cluster`` hands to users, and the operators' ``gibbs`` flags, of
basicrta_torch against the JAX package on the CPU.

On one results tree (three residues sampled by the port's plain engine):
tau of every cluster, ``tausout_all.npy``, the convergence table and
``diagnostics.npz``, and the b-factor PDB equal the JAX package's on the
same artifacts, and the result file, stored without deflating, reads the
same in both packages. ``gibbs --mode sequential`` gives each residue the tau of
``Gibbs(...).run()`` alone; ``--rerun-missing``, ``--rerun-flagged`` (with
a JAX-written archive) and ``--profile``; the figure families with
matplotlib, and ``cluster`` with matplotlib blocked still writing every
data file; ``protein.homologues`` against the JAX package to 1e-12; and
``python -m basicrta_torch.{kinetics,gibbs,cluster}``."""

import contextlib
import io
import json
import os
import runpy
import shutil
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, see conftest)
import numpy as np
import pytest

from basicrta_tpu.io.topology import Topology as JTopology
from basicrta_tpu.protein import homologues as jhom
from basicrta_tpu.protein.driver import ProcessProtein as JProcessProtein
from basicrta_tpu.sampler.gibbs import Gibbs as JGibbs
from basicrta_torch import cli
from basicrta_torch.config import GibbsConfig
from basicrta_torch.contacts.records import ContactEvents, ContactMeta
from basicrta_torch.io.topology import Topology, write_pdb
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.postprocess import tau as ptau
from basicrta_torch.protein import homologues as hom
from basicrta_torch.protein.driver import ProcessProtein
from basicrta_torch.sampler.gibbs import Gibbs, run_residue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NITER = "2000"      # the synthetic results tree
RUN = "100"         # the sampled one
GIBBS = ["--niter", RUN, "--g", "10", "--ncomp", "4", "--nchains", "2",
         "--engine", "torch"]
SIZES = {10: 1500, 20: 500, 30: 300}


def _times(n, seed):
    return discretize_times(simulate_hyperexp(
        n, [0.85, 0.15], [2.0, 0.1], np.random.default_rng(seed)), 0.1)


def _events():
    resids = np.concatenate([np.full(n, r, np.int32)
                             for r, n in SIZES.items()])
    dur = np.concatenate([_times(n, r) for r, n in SIZES.items()])
    return ContactEvents(resids, np.zeros_like(resids), np.zeros_like(dur),
                         dur, ContactMeta(cutoff=7.0))


def _chains(seed, S=200, K=5):
    """Two chains of a well-separated posterior: a fast (w 0.8, r 2) and
    a slow (w 0.2, r 0.1 + 0.05 seed) component, the rest below the
    weight cutoff, an occasional third live one."""
    rng = np.random.default_rng(seed)
    W = np.full((2, S, K), 1e-6)
    R = rng.uniform(0.5, 5.0, (2, S, K))
    W[..., 0] = rng.normal(0.78, 0.01, (2, S))
    W[..., 1] = rng.normal(0.2, 0.01, (2, S))
    R[..., 0] = rng.lognormal(np.log(2.0), 0.03, (2, S))
    R[..., 1] = rng.lognormal(np.log(0.1 + 0.05 * seed), 0.05, (2, S))
    extra = rng.random((2, S)) < 0.2
    W[..., 2][extra] = 0.02
    return W.astype(np.float32), R.astype(np.float32)


def _main(argv, cwd):
    """cli.main in ``cwd``; returns (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(argv)
    finally:
        os.chdir(old)
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A results tree of three residues x 2 chains whose (synthetic)
    posteriors the port processed on the CPU, saved as ``gibbs`` saves."""
    d = str(tmp_path_factory.mktemp("outputs"))
    cfg = GibbsConfig(ncomp=5, niter=int(NITER), g=10, burnin=200,
                      gmm_n_init=4, n_chains=2)
    ev = _events()
    for i, r in enumerate(SIZES):
        g = Gibbs(ev.times_for_residue(r), residue=f"X{r}", cutoff=7.0,
                  cfg=cfg, root=d)
        g.mcweights, g.mcrates = _chains(i)
        g.process_gibbs(save=False, device="cpu")
        g.estimate_tau()
        g.save()
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A results tree sampled by ``gibbs --engine torch`` (100 sweeps)."""
    d = str(tmp_path_factory.mktemp("runs"))
    _events().save(os.path.join(d, "contacts_7.0.npz"))
    _main(["gibbs", "--contacts", "contacts_7.0.npz", *GIBBS], d)
    return d


def _copy(tree, dst):
    shutil.copytree(tree, dst)
    return str(dst)


def _paths(tree, niter=NITER):
    return {lab: os.path.join(tree, "basicrta-7.0", lab,
                              f"gibbs_{niter}.npz")
            for lab in ("X10", "X20", "X30")}


def _pp(root, jax=False, niter=NITER, **kw):
    if jax:
        from basicrta_tpu.config import GibbsConfig as JConfig
        return JProcessProtein(cfg=JConfig(niter=int(niter)), cutoff=7.0,
                               root=root, **kw)
    return ProcessProtein(cfg=GibbsConfig(niter=int(niter)), cutoff=7.0,
                          root=root, device="cpu", **kw)


# ------------------------------------------------------ protein outputs
@pytest.mark.parametrize("label", ["X10", "X20", "X30"])
def test_estimate_tau_all_equal_jax(tree, label):
    path = _paths(tree)[label]
    a, b = Gibbs.load(path), JGibbs.load(path)
    ta, tb = a.estimate_tau_all(), b.estimate_tau_all()
    np.testing.assert_array_equal(ta, tb)
    assert ta.shape[1] == 4 and np.all(np.diff(ta[:, 2]) <= 1e-9)
    assert ta[0, 2] == pytest.approx(a.tau[1], rel=1e-12)
    np.testing.assert_array_equal(
        ptau.estimate_tau_all(a.processed, a.cfg.noise_cutoff),
        ta)


@pytest.mark.parametrize("label", ["X10", "X20", "X30"])
def test_result_file_is_stored_and_both_packages_read_it(
        tree, tmp_path, monkeypatch, label):
    """``Gibbs.save`` stores every entry of ``gibbs_{niter}.npz`` without
    deflating it; its keys and arrays are those of a deflated save of the
    same ``Gibbs``, and the JAX package's ``Gibbs.load`` reads it to the
    port's arrays."""
    import zipfile
    path = _paths(tree)[label]
    with zipfile.ZipFile(path) as zf:
        assert {i.compress_type for i in zf.infolist()} == {
            zipfile.ZIP_STORED}
    g = Gibbs.load(path)
    g.root = str(tmp_path)
    with monkeypatch.context() as m:
        m.setattr(np, "savez", np.savez_compressed)
        deflated = g.save()
    with zipfile.ZipFile(deflated) as zf:
        assert {i.compress_type for i in zf.infolist()} == {
            zipfile.ZIP_DEFLATED}
    with np.load(path) as a, np.load(deflated) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "tau" in a.files and "proc_data" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    a, j = Gibbs.load(path), JGibbs.load(path)
    assert (a.residue, a.cutoff, a.ts, a.tau) == (j.residue, j.cutoff,
                                                  j.ts, j.tau)
    assert a.cfg.to_json() == j.cfg.to_json()
    for f in ("times", "mcweights", "mcrates", "parameters", "intervals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(j, f))
    assert a.processed.lmode == j.processed.lmode
    for f in ("labels", "data", "pindicator_values", "presorts"):
        np.testing.assert_array_equal(getattr(a.processed, f),
                                      getattr(j.processed, f))
    for x, y in zip(a.processed.inds, j.processed.inds):
        np.testing.assert_array_equal(x, y)


def test_estimate_tau_all_all_noise_raises(tree):
    g = Gibbs.load(_paths(tree)["X10"])
    g.processed.pindicator_values = np.zeros_like(
        g.processed.pindicator_values)
    with pytest.raises(ptau.AllNoiseError):
        ptau.estimate_tau_all(g.processed, g.cfg.noise_cutoff)


def test_taus_all_and_tausout_all_equal_jax(tree):
    pp, jp = _pp(tree), _pp(tree, jax=True)
    a, b = pp.get_taus_all(), jp.get_taus_all()
    assert sorted(a) == sorted(b) == ["X10", "X20", "X30"]
    for lab in a:
        np.testing.assert_array_equal(a[lab], b[lab])
    pa = pp.write_data(fname="t_torch", all_clusters=True)
    pb = jp.write_data(fname="t_jax", all_clusters=True)
    np.testing.assert_array_equal(np.load(pa), np.load(pb))
    ra, rb = np.load(pa[:-4] + "_all.npy"), np.load(pb[:-4] + "_all.npy")
    assert ra.shape[1] == 5 and set(ra[:, 0]) == {10.0, 20.0, 30.0}
    np.testing.assert_array_equal(ra, rb)


def test_diagnostics_equal_jax_and_cross_load(tree):
    pp, jp = _pp(tree), _pp(tree, jax=True)
    la, ra = pp.diagnostics_table()
    lb, rb = jp.diagnostics_table()
    assert la == lb == ["X10", "X20", "X30"]
    np.testing.assert_array_equal(ra, rb)
    for kw in ({}, dict(rhat_warn=0.0), dict(rhat_warn=1e9, ess_warn=0.0)):
        pa, fa = pp.write_diagnostics(fname="d_torch", **kw)
        pb, fb = jp.write_diagnostics(fname="d_jax", **kw)
        assert fa == fb
        with np.load(pa) as za, np.load(pb) as zb:
            assert za.files == zb.files
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
    assert fa == [] and len(pp.write_diagnostics(rhat_warn=0.0)[1]) == 3


def test_b_color_structure_equal_jax(tree, tmp_path):
    top = Topology(np.array(["N", "CA", "CA", "CA", "C1"]),
                   np.array([10, 10, 20, 30, 900], np.int32),
                   np.array(["TRP", "TRP", "ALA", "GLY", "CHOL"]),
                   np.arange(15, dtype=np.float32).reshape(5, 3))
    struct = write_pdb(str(tmp_path / "s.pdb"), top)
    a = _pp(tree).b_color_structure(struct, out="b_torch.pdb")
    b = _pp(tree, jax=True).b_color_structure(struct, out="b_jax.pdb")
    assert open(a, "rb").read() == open(b, "rb").read()
    atoms = [ln for ln in open(a) if ln.startswith("ATOM")]
    assert len(atoms) == 4          # the protein atoms only
    tau10 = Gibbs.load(_paths(tree)["X10"]).tau[1]
    assert float(atoms[0][60:66]) == pytest.approx(tau10, abs=0.006)


# --------------------------------------------------------- gibbs flags
def test_mode_sequential_is_gibbs_run_alone(runs, tmp_path):
    d = str(tmp_path)
    _events().save(os.path.join(d, "contacts_7.0.npz"))
    _main(["gibbs", "--contacts", "contacts_7.0.npz", *GIBBS, "--mode",
           "sequential", "--resid", "20", "30"], d)
    assert sorted(os.listdir(os.path.join(d, "basicrta-7.0"))) == \
        ["X20", "X30"]
    # the CLI's configuration (burn-in min(10000, max(g, niter / 10)))
    cfg = GibbsConfig(ncomp=4, niter=int(RUN), g=10, burnin=10,
                      n_chains=2)
    ev = _events()
    for r in (20, 30):
        lab = f"X{r}"
        got = Gibbs.load(_paths(d, RUN)[lab])
        alone = Gibbs(ev.times_for_residue(r), residue=lab, cutoff=7.0,
                      cfg=cfg, root=str(tmp_path / "alone"))
        alone.run(engine="torch", save=False).process_gibbs(save=False)
        np.testing.assert_array_equal(got.mcweights, alone.mcweights)
        np.testing.assert_array_equal(got.processed.labels,
                                      alone.processed.labels)
        assert got.tau == tuple(alone.estimate_tau())
        # on record: batched mode draws other chains for the same residue,
        # since a bucket's seed is salted by its residue names (as in the
        # JAX package) and X20, X30 share a bucket with other residues
        batched = Gibbs.load(_paths(runs, RUN)[lab])
        assert batched.mcweights.shape == got.mcweights.shape
        assert not np.array_equal(got.mcweights, batched.mcweights)
        assert np.isfinite(batched.tau).all() and np.isfinite(got.tau).all()


def test_run_residue_and_unknown_mode(tmp_path):
    x = _times(300, 4)
    cfg = GibbsConfig(ncomp=3, niter=100, g=10, burnin=20, n_chains=1)
    g = run_residue(x, "W4", 7.0, cfg, root=str(tmp_path), engine="torch")
    h = Gibbs(x, residue="W4", cutoff=7.0, cfg=cfg, root=str(tmp_path))
    h.run(engine="torch", save=False).process_gibbs(save=False)
    assert tuple(g.tau) == tuple(h.estimate_tau())
    assert os.path.exists(os.path.join(g.savedir, "gibbs_100.npz"))
    from basicrta_torch.protein.driver import ParallelGibbs
    with pytest.raises(ValueError, match="mode"):
        ParallelGibbs(_events(), root=str(tmp_path)).run(mode="pooled",
                                                         engine="torch")


def test_rerun_missing(runs, tmp_path):
    d = _copy(runs, tmp_path / "t")
    os.remove(_paths(d, RUN)["X30"])
    keep = os.path.getmtime(_paths(d, RUN)["X10"])
    _, err = _main(["gibbs", "--contacts", "contacts_7.0.npz", *GIBBS,
                    "--rerun-missing"], d)
    assert "1 missing residues: X30" in err
    assert "rerunning 1 residues: X30" in err
    assert os.path.exists(_paths(d, RUN)["X30"])
    assert os.path.getmtime(_paths(d, RUN)["X10"]) == keep
    _, err = _main(["gibbs", "--contacts", "contacts_7.0.npz", *GIBBS,
                    "--rerun-missing"], d)
    assert "nothing to rerun" in err


@pytest.mark.parametrize("archive", ["jax", "jax_without_flagged"])
def test_rerun_flagged_reads_jax_diagnostics(runs, tmp_path, archive):
    d = _copy(runs, tmp_path / "t")
    # the JAX package screens a tree that holds X30 only and flags it
    only = str(tmp_path / "only")
    os.makedirs(os.path.join(only, "basicrta-7.0"))
    shutil.copytree(os.path.join(d, "basicrta-7.0", "X30"),
                    os.path.join(only, "basicrta-7.0", "X30"))
    path, flagged = _pp(only, jax=True, niter=RUN).write_diagnostics(
        rhat_warn=0.0)
    assert flagged == ["X30"]
    if archive == "jax_without_flagged":
        with np.load(path) as z:
            legacy = {k: z[k] for k in z.files if k != "flagged"}
        path = os.path.join(only, "legacy.npz")
        np.savez(path, **legacy)
    keep = os.path.getmtime(_paths(d, RUN)["X10"])
    _, err = _main(["gibbs", "--contacts", "contacts_7.0.npz", *GIBBS,
                    "--rerun-flagged", path], d)
    assert "1 flagged residues: X30" in err
    assert "rerunning 1 residues: X30" in err
    assert os.path.getmtime(_paths(d, RUN)["X10"]) == keep


def test_rerun_flagged_refuses_other_archives(runs, tmp_path):
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, x=np.zeros(3))
    with pytest.raises(SystemExit, match="not a diagnostics archive"):
        _main(["gibbs", "--contacts", "contacts_7.0.npz", *GIBBS,
               "--rerun-flagged", bad], runs)


def test_profile_writes_a_trace(runs, tmp_path):
    d = _copy(runs, tmp_path / "t")
    trace = str(tmp_path / "trace")
    _main(["gibbs", "--contacts", "contacts_7.0.npz", "--niter", "40",
           "--g", "10", "--ncomp", "3", "--nchains", "1", "--engine",
           "torch", "--resid", "30", "--profile", trace], d)
    assert os.path.exists(os.path.join(d, "basicrta-7.0", "X30",
                                       "gibbs_40.npz"))
    with open(os.path.join(trace, "gibbs_trace.json")) as f:
        assert json.load(f)["traceEvents"]


# ------------------------------------------------------------- figures
@pytest.fixture(scope="module")
def fitted(tree):
    g = Gibbs.load(_paths(tree)["X10"])
    g.device = "cpu"
    return g


def test_gibbs_plot_methods(fitted):
    import matplotlib.pyplot as plt
    g = fitted
    for method, outfile in [(g.plot_surv, "s_vs_t.png"),
                            (g.plot_gibbs, "plot_results.png"),
                            (g.plot_hist, "hist_results.png"),
                            (g.plot_tau_hist, "tau_hist.png"),
                            (g.result_plot,
                             "weight_vs_rate_results_all.png")]:
        plt.close(method())
        assert os.path.exists(os.path.join(g.savedir, outfile))


def test_mixture_and_plot_families(fitted):
    import matplotlib.pyplot as plt
    g = fitted
    labels, presorts = g.mixture_and_plot(remove_noise=True)
    assert len(labels) == len(g.processed.labels) and presorts is not None
    for subset in ("train", "validate", "all"):
        for fam in ("combined_results", "result_hist", "weight_results",
                    "rate_results", "weight_vs_rate_results"):
            for ext in ("png", "pdf"):
                assert os.path.exists(os.path.join(
                    g.savedir, f"{fam}_{subset}_noiserm.{ext}"))
    plt.close("all")


def test_residue_plot_family_and_collect(fitted, tmp_path, monkeypatch):
    import matplotlib.pyplot as plt
    from basicrta_torch.plots import (all_post_hist, check_results_placeholder,
                                      collect_n_plot, load_tm_dict,
                                      plot_hists, plot_post, plot_r_vs_w)
    g = fitted
    g.make_residue_plots()
    K = len(np.unique(g.processed.labels))
    figdir = os.path.join(g.savedir, "figs")
    for fam in (f"k{K}-ml_results", f"k{K}-mean_results",
                f"k{g.cfg.ncomp}-trace_weights", f"k{g.cfg.ncomp}-trace_rates",
                f"k{K}-posterior_weights_comp-0"):
        assert os.path.exists(os.path.join(figdir, f"{fam}.png")), fam
    all_post_hist(g)
    plot_post(g, "rates", comp=[0])
    plot_r_vs_w(g)
    for fam in (f"k{K}-posterior_rates_comp-all",
                f"k{K}-posterior_rates_comps-0", "r_vs_w"):
        assert os.path.exists(os.path.join(figdir, f"{fam}.png")), fam
    assert collect_n_plot(resids=[10], cutoff=7.0, niter=int(NITER),
                          root=g.root) == ["X10"]
    monkeypatch.chdir(tmp_path)
    plot_hists([g.times], [g.pindicator_per_event().T], ["X10"])
    assert os.path.exists(
        f"result_check/X10_hists_{g.processed.lmode}.pdf")
    check_results_placeholder("X5", g.times[:100], 0.1)
    assert os.path.exists("result_check/X5-s-vs-t.png")
    assert "tm1" in load_tm_dict()["b2ar"]["helices"]
    lit = tmp_path / "tm_dict.txt"          # the reference's literal form
    lit.write_text("{'x': {'helices': {'tm1': [1, 5]}}}")
    assert load_tm_dict(str(lit))["x"]["helices"]["tm1"] == [1, 5]
    plt.close("all")


def test_protein_figures(tree, tmp_path):
    import matplotlib.pyplot as plt
    tree = _copy(tree, tmp_path / "t")
    pp = _pp(tree, prot="b2ar")
    plt.close(pp.plot_protein())
    plt.close(pp.plot_taus_all())
    for name in ("t_slow", "tau_clusters"):
        assert os.path.exists(os.path.join(tree, "figs", f"{name}.png"))


def test_cluster_reprocess_with_the_ports_em(tree):
    g = Gibbs.load(_paths(tree)["X20"])
    before = g.processed.lmode
    g.cluster(device="cpu", gmm_n_init=2)
    assert g.cfg.gmm_n_init == 2
    assert abs(g.processed.lmode - before) <= 1
    assert g.parameters.shape == (g.processed.lmode, 2)


def test_sklearn_clustering_equals_jax(tree):
    path = _paths(tree)["X10"]
    a, b = Gibbs.load(path), JGibbs.load(path)
    kw = dict(method="BayesianGaussianMixture", random_state=0)
    a.cluster(device="cpu", **kw)
    b.cluster(**kw)
    assert a.processed.lmode == b.processed.lmode
    np.testing.assert_array_equal(a.processed.data, b.processed.data)
    for x, y in zip(a.processed.inds, b.processed.inds):
        np.testing.assert_array_equal(x, y)
    assert a.processed.pindicator_values.shape == \
        b.processed.pindicator_values.shape


_BLOCK = ("import sys, runpy\n"
          "sys.modules['matplotlib'] = None\n"
          "sys.modules['sklearn'] = None\n"
          "sys.argv = ['basicrta_torch'] + sys.argv[1:]\n"
          "runpy.run_module('basicrta_torch', run_name='__main__')\n")


def test_cluster_writes_every_data_file_without_matplotlib(tree, tmp_path):
    d = _copy(tree, tmp_path / "t")
    top = Topology(np.array(["CA", "CA", "CA"]),
                   np.array([10, 20, 30], np.int32),
                   np.array(["TRP", "ALA", "GLY"]),
                   np.zeros((3, 3), np.float32))
    write_pdb(os.path.join(d, "s.pdb"), top)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK, "cluster", "--cutoff", "7.0",
         "--niter", NITER, "--engine", "torch", "--all-clusters",
         "--diagnostics", "--structure", "s.pdb", "--prot", "b2ar"],
        capture_output=True, text=True, cwd=d, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for f in ("tausout.npy", "tausout_all.npy", "diagnostics.npz",
              "tau_bcolored.pdb"):
        assert os.path.exists(os.path.join(d, f)), f
    assert not os.path.exists(os.path.join(d, "figs"))
    lines = [ln for ln in out.stderr.splitlines() if "not drawn" in ln]
    assert lines == ["figs/t_slow.png not drawn: matplotlib is not "
                     "installed", "figs/tau_clusters.png not drawn: "
                     "matplotlib is not installed"]
    np.testing.assert_array_equal(
        np.load(os.path.join(d, "tausout_all.npy")),
        np.load(_pp(tree, jax=True).write_data(
            fname="ref", all_clusters=True)[:-4] + "_all.npy"))


def test_cluster_cli_with_matplotlib(tree, tmp_path):
    d = _copy(tree, tmp_path / "t")
    out, _ = _main(["cluster", "--cutoff", "7.0", "--niter", NITER,
                    "--engine", "torch", "--all-clusters"], d)
    assert "wrote figs/t_slow.png" in out
    assert "wrote figs/tau_clusters.png" in out
    for f in ("tausout.npy", "tausout_all.npy", "figs/t_slow.png",
              "figs/tau_clusters.pdf"):
        assert os.path.exists(os.path.join(d, f)), f


# ---------------------------------------------------------- homologues
ALN = """>protA/1-6
MKT-LVW
>protB|x
MRTA-VW
"""


def test_homologues_equal_jax(tmp_path):
    p = tmp_path / "aln.fa"
    p.write_text(ALN)
    assert hom.parse_fasta_alignment(str(p)) == \
        jhom.parse_fasta_alignment(str(p))
    seqs = list(hom.parse_fasta_alignment(str(p)).values())
    for ident in (False, True):
        for x, y in zip(hom.matched_columns(*seqs, identical_only=ident),
                        jhom.matched_columns(*seqs, identical_only=ident)):
            np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(21)
    P = rng.normal(size=(30, 3))
    Q = P @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 1.5
    for x, y in zip(hom.kabsch(P, Q), jhom.kabsch(P, Q)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    rA, rB = np.arange(101, 107), np.arange(201, 207)
    tA = np.array([[101, 10.0], [102, 5.0], [103, 2.0], [105, 7.0],
                   [106, 3.0]])
    tB = np.array([[201, 8.0], [202, 1.0], [203, 2.0], [205, 4.0],
                   [206, 3.5]])
    for ident in (False, True):
        for x, y in zip(hom.delta_tau(str(p), rA, rB, tA, tB, ident),
                        jhom.delta_tau(str(p), rA, rB, tA, tB, ident)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    # structures: 6 and 6 residues of one CA each
    posA = rng.normal(size=(6, 3)) * 5
    posB = posA @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 3.0
    args = (np.array(["CA"] * 6), np.arange(1, 7, dtype=np.int32),
            np.array(["ALA"] * 6))
    a = hom.align_homologues(Topology(*args, posA.astype(np.float32)),
                             Topology(*args, posB.astype(np.float32)),
                             str(p))
    b = jhom.align_homologues(JTopology(*args, posA.astype(np.float32)),
                              JTopology(*args, posB.astype(np.float32)),
                              str(p))
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-12)
    assert abs(a[1] - b[1]) <= 1e-12


def test_plot_delta_tau(tmp_path):
    import matplotlib.pyplot as plt
    a = np.array([101, 102, 103, 105])
    fig = hom.plot_delta_tau(a, a + 100, np.array([9.0, -0.5, 0.2, -8.0]),
                             basename=str(tmp_path / "dt"))
    plt.close(fig)
    assert os.path.exists(tmp_path / "dt.png")


@pytest.mark.parametrize("module", ["basicrta_torch.kinetics",
                                    "basicrta_torch.gibbs",
                                    "basicrta_torch.cluster"])
def test_module_entry_points(module, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [module, "--help"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module(module, run_name="__main__")
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert f"basicrta-torch {module.split('.')[-1]}" in out
