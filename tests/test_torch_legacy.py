"""basicrta_torch.io.legacy against basicrta_tpu.io.legacy: every case of
tests/test_legacy.py run through both packages on the same fabricated
pickles, plus the port's four ``.pkl`` entry points (``Gibbs.load``,
``ParallelGibbs``, ``ProcessProtein.collect_results`` and ``MapKinetics``,
the last two also through the CLI).

Real reference pickles need basicrta and MDAnalysis to unpickle; the
pickles here have the reference's module paths and dtype-metadata layout,
written with throwaway stand-in modules that are REMOVED before loading
(``tests/test_legacy.py``'s ``_fake_modules``), so the loaders must work
with no legacy package importable. Protocols 2 and 5 and both numpy
module spellings (``numpy.core`` before numpy 2, ``numpy._core`` after)
are covered.
"""

import os
import pickle
import pickletools

import numpy as np
import pytest

from basicrta_tpu.config import GibbsConfig as JConfig
from basicrta_tpu.io import legacy as jleg
from basicrta_tpu.postprocess.clustering import ClusterResult as JResult
from basicrta_tpu.postprocess.tau import estimate_params as jparams
from basicrta_tpu.postprocess.tau import estimate_tau as jtau
from basicrta_tpu.protein.driver import ParallelGibbs as JParallelGibbs
from basicrta_tpu.protein.driver import ProcessProtein as JProcessProtein
from basicrta_torch import cli
from basicrta_torch.config import GibbsConfig
from basicrta_torch.contacts.records import ContactEvents, ContactRecords
from basicrta_torch.io import legacy
from basicrta_torch.postprocess.clustering import ClusterResult
from basicrta_torch.postprocess.tau import estimate_params, estimate_tau
from basicrta_torch.protein.driver import ParallelGibbs, ProcessProtein
from basicrta_torch.sampler.gibbs import Gibbs
from tests.test_legacy import _cleanup, _fake_modules

PROTOCOLS = (2, 5)
NUMPY_CORES = ("numpy.core", "numpy._core")


def _dump(obj, path, protocol=5, core="numpy._core"):
    """Pickle ``obj`` with numpy's reconstruction machinery named under
    ``core``: the spelling of numpy < 2 or >= 2, whichever this numpy
    writes. Protocol 2 names a module in a text GLOBAL line, 4+ in a
    length-prefixed string whose frames ``pickletools.optimize`` lays out
    again."""
    data = pickle.dumps(obj, protocol=protocol)
    for mod in ("multiarray", "numeric"):
        for other in NUMPY_CORES:
            old, new = f"{other}.{mod}".encode(), f"{core}.{mod}".encode()
            if protocol < 4:
                data = data.replace(b"c" + old + b"\n", b"c" + new + b"\n")
            else:
                data = data.replace(b"\x8c" + bytes([len(old)]) + old,
                                    b"\x8c" + bytes([len(new)]) + new)
    data = pickletools.optimize(data)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _contact_table(tmp_path, ncols, protocol=5, core="numpy._core",
                   name=None):
    mods, _, _, AtomGroup = _fake_modules()
    try:
        dtype = np.dtype(np.float64, metadata={
            "top": "top.gro", "traj": "traj.xtc",
            "ag1": AtomGroup("p"), "ag2": AtomGroup("l"),
            "ts": 0.1, "cutoff": 10.0})
        if ncols == 5:
            rows = np.array([[0, 1, 9, 3.5, 0.0],
                             [1, 1, 9, 2.0, 0.1],
                             [4, 2, 9, 6.0, 0.4]])
        else:
            rows = np.array([[1, 9, 0.0, 0.2],
                             [2, 9, 0.4, 0.1]])
        p = str(tmp_path / (name or f"contacts_{ncols}_{protocol}.pkl"))
        _dump(rows.astype(dtype), p, protocol, core)
    finally:
        _cleanup(mods)
    return p


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("core", NUMPY_CORES)
def test_primary_map_equals_jax(tmp_path, protocol, core):
    p = _contact_table(tmp_path, 5, protocol, core)
    with open(p, "rb") as f:
        assert core.encode() + b"." in f.read()     # the spelling tested
    rec, jrec = legacy.load_reference_contacts(p), \
        jleg.load_reference_contacts(p)
    assert isinstance(rec, ContactRecords)
    assert rec.meta.ts == pytest.approx(0.1)
    assert rec.meta.cutoff == pytest.approx(10.0)
    assert rec.meta.top == "top.gro" and rec.meta.traj == "traj.xtc"
    assert rec.meta.to_dict() == jrec.meta.to_dict()
    for f in ("frames", "sel1_resids", "sel2_resids", "min_dist", "times"):
        a, b = getattr(rec, f), getattr(jrec, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rec.frames, [0, 1, 4])
    np.testing.assert_allclose(rec.min_dist, [3.5, 2.0, 6.0])


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("core", NUMPY_CORES)
def test_event_table_equals_jax(tmp_path, protocol, core):
    p = _contact_table(tmp_path, 4, protocol, core)
    with open(p, "rb") as f:
        assert core.encode() + b"." in f.read()
    ev, jev = legacy.load_reference_contacts(p), \
        jleg.load_reference_contacts(p)
    assert isinstance(ev, ContactEvents)
    for f in ("sel1_resids", "sel2_resids", "start_times", "durations"):
        a, b = getattr(ev, f), getattr(jev, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ev.times_for_residue(1), [0.2])
    np.testing.assert_array_equal(ev.times_for_residue(2),
                                  jev.times_for_residue(2))


def test_allowlists_are_the_jax_packages():
    assert legacy._ALLOWED_CLASSES == jleg._ALLOWED_CLASSES
    assert legacy._ALLOWED_BUILTINS == jleg._ALLOWED_BUILTINS
    assert legacy._STUBBED_ROOTS == jleg._STUBBED_ROOTS


def test_wrong_shape_refused_as_jax(tmp_path):
    p = str(tmp_path / "odd.pkl")
    with open(p, "wb") as f:
        pickle.dump(np.zeros((3, 6)), f)
    for mod in (legacy, jleg):
        with pytest.raises(ValueError, match="unrecognized"):
            mod.load_reference_contacts(p)


def _gadgets(tmp_path):
    """(name, path) of every pickle both loaders must refuse."""
    out = []
    p = str(tmp_path / "evil.pkl")
    with open(p, "wb") as f:
        pickle.dump({"x": pickle.dumps}, f)   # a pickle module function
    out.append(("pickle.dumps", p))

    class Evil:
        def __reduce__(self):
            return (eval, ("1+1",))

    p = str(tmp_path / "gadget.pkl")
    with open(p, "wb") as f:
        pickle.dump(Evil(), f)
    out.append(("eval", p))
    for i, target in enumerate(
            ((np.save, (str(tmp_path / "pwned.npy"), [1])),
             (np.fromfile, (str(tmp_path / "x"),)))):
        class NpEvil:
            def __reduce__(self, _t=target):
                return _t
        p = str(tmp_path / f"np_gadget{i}.pkl")
        with open(p, "wb") as f:
            pickle.dump(NpEvil(), f)
        out.append((target[0].__name__, p))

    def short_unicode(s):
        b = s.encode()
        return b"\x8c" + bytes([len(b)]) + b

    # protocol-4 dotted-name resolution, crafted by hand
    p = str(tmp_path / "dotted.pkl")
    with open(p, "wb") as f:
        f.write(b"\x80\x04" + short_unicode("numpy")
                + short_unicode("random.default_rng")
                + b"\x93" + b")" + b"R" + b".")
    out.append(("dotted", p))
    return out


@pytest.mark.parametrize("which", ["pickle.dumps", "eval", "save",
                                   "fromfile", "dotted"])
def test_gadgets_refused_as_jax(tmp_path, which):
    path = dict(_gadgets(tmp_path))[which]
    for mod in (legacy, jleg):
        with pytest.raises(pickle.UnpicklingError):
            mod.load_reference_pickle(path)
    assert not (tmp_path / "pwned.npy").exists()


def _gibbs_pickle(path, rng, label="W313", S=60, K=5, n=3000, protocol=5,
                  core="numpy._core"):
    """A reference ``Gibbs`` pickle: times, chain, configuration."""
    mods, Gibbs_ref, Results, _ = _fake_modules()
    try:
        g = Gibbs_ref()
        g.times = np.round(rng.exponential(1.0, n), 1) + 0.1
        g.residue = label
        g.ncomp, g.niter, g.g, g.burnin = K, (S - 1) * 10, 10, 100
        g.cutoff = 7.0
        g.ts = 0.1
        g.mcweights = rng.dirichlet(np.ones(K), S)
        g.mcrates = rng.gamma(2.0, 1.0, (S, K))
        g.processed_results = Results()
        _dump(g, str(path), protocol, core)
    finally:
        _cleanup(mods)
    return g


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("core", NUMPY_CORES)
def test_gibbs_pickle_equals_jax(tmp_path, rng, protocol, core):
    ref = _gibbs_pickle(tmp_path / "gibbs_590.pkl", rng, protocol=protocol,
                        core=core)
    p = str(tmp_path / "gibbs_590.pkl")
    ours = legacy.load_reference_gibbs(p, root=str(tmp_path))
    theirs = jleg.load_reference_gibbs(p, root=str(tmp_path))
    assert isinstance(ours, Gibbs)
    assert ours.residue == theirs.residue == "W313"
    assert ours.cutoff == theirs.cutoff == 7.0
    assert ours.cfg.to_json() == theirs.cfg.to_json()
    assert ours.cfg.ncomp == 5 and ours.cfg.g == 10
    assert ours.ts == theirs.ts
    for f in ("times", "mcweights", "mcrates"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    assert ours.mcweights.shape == (1, 60, 5)      # the chain axis added
    np.testing.assert_array_equal(ours.mcweights[0], ref.mcweights)
    np.testing.assert_array_equal(ours._values, theirs._values)
    np.testing.assert_array_equal(ours._counts, theirs._counts)
    np.testing.assert_array_equal(ours.s, theirs.s)


def test_gibbs_load_dispatches_pkl_and_processes(tmp_path, rng):
    """``Gibbs.load`` takes a reference pickle in a results tree; its chain
    drives the port's post-processing on the CPU, and tau from the same
    clusters matches the JAX package's to f32 rounding."""
    d = tmp_path / "basicrta-7.0" / "W313"
    d.mkdir(parents=True)
    _gibbs_pickle(d / "gibbs_590.pkl", rng)
    g = Gibbs.load(str(d / "gibbs_590.pkl"))
    assert g.root == str(tmp_path) and g.processed is None
    g.cfg = GibbsConfig.from_json(
        g.cfg.to_json().replace('"gmm_n_init": 117', '"gmm_n_init": 8'))
    g.process_gibbs(save=False, device="cpu")
    assert g.processed is not None and g.parameters.shape[1] == 2
    lo, tau, hi = g.estimate_tau()
    assert np.isfinite(tau) and 0 <= lo <= hi
    # the same clusters through the JAX package's estimators
    p = g.processed
    jres = JResult(lmode=p.lmode, labels=p.labels, inds=p.inds,
                   data=p.data, pindicator_values=p.pindicator_values,
                   presorts=p.presorts)
    res = ClusterResult(lmode=p.lmode, labels=p.labels, inds=p.inds,
                        data=p.data, pindicator_values=p.pindicator_values,
                        presorts=p.presorts)
    np.testing.assert_allclose(estimate_params(res)[0], jparams(jres)[0],
                               rtol=2e-7)
    np.testing.assert_allclose(estimate_tau(res, 0.4), jtau(jres, 0.4),
                               rtol=2e-7)


def _event_pickle(tmp_path, rng, name="contacts_7.0.pkl", top=None,
                  traj=None, rows=None):
    mods, _, _, AtomGroup = _fake_modules()
    try:
        dtype = np.dtype(np.float64, metadata={
            "top": top or "top.gro", "traj": traj or "traj.xtc",
            "ag1": AtomGroup("p"), "ag2": AtomGroup("l"),
            "ts": 0.1, "cutoff": 7.0})
        if rows is None:
            rows = np.stack([
                np.repeat([5, 8], 20),                      # sel1 resids
                np.full(40, 900),                           # sel2 resid
                np.arange(40, dtype=float),                 # start times
                np.round(rng.exponential(0.5, 40), 1) + .1  # durations
            ], axis=1)
        p = str(tmp_path / name)
        _dump(rows.astype(dtype), p)
    finally:
        _cleanup(mods)
    return p


def test_parallel_gibbs_accepts_reference_pickle(tmp_path, rng):
    p = _event_pickle(tmp_path, rng)
    pg = ParallelGibbs(p, root=str(tmp_path))
    jpg = JParallelGibbs(p, root=str(tmp_path))
    assert pg.cutoff == jpg.cutoff == pytest.approx(7.0)
    assert len(pg.events.times_for_residue(5)) == 20
    for r in (5, 8):
        np.testing.assert_array_equal(pg.events.times_for_residue(r),
                                      jpg.events.times_for_residue(r))


def test_parallel_gibbs_refuses_a_primary_map_pickle(tmp_path):
    p = _contact_table(tmp_path, 5, name="contacts_7.0.pkl")
    for cls in (ParallelGibbs, JParallelGibbs):
        with pytest.raises(ValueError, match="primary contact map"):
            cls(p, root=str(tmp_path))


def test_cli_gibbs_on_a_pkl_equals_the_npz(tmp_path, rng, monkeypatch):
    """``gibbs --contacts contacts_7.0.pkl`` runs the pickle's events and
    samples them bitwise as the same events from an ``.npz``."""
    p = _event_pickle(tmp_path, rng)
    events = legacy.load_reference_contacts(p)
    args = ["--niter", "40", "--g", "10", "--ncomp", "3", "--nchains", "1",
            "--engine", "torch"]
    out = {}
    for kind in ("pkl", "npz"):
        work = tmp_path / kind
        work.mkdir()
        src = p
        if kind == "npz":
            src = str(work / "contacts_7.0.npz")
            events.save(src)
        monkeypatch.chdir(work)
        cli.main(["gibbs", "--contacts", src] + args)
        out[kind] = {lab: Gibbs.load(str(work / "basicrta-7.0" / lab /
                                         "gibbs_40.npz"))
                     for lab in ("X5", "X8")}
    for lab in ("X5", "X8"):
        np.testing.assert_array_equal(out["pkl"][lab].mcweights,
                                      out["npz"][lab].mcweights)
        np.testing.assert_array_equal(out["pkl"][lab].mcrates,
                                      out["npz"][lab].mcrates)


def _reference_tree(tmp_path, rng, labels=("W5", "L8"), S=60, K=5):
    for label in labels:
        d = tmp_path / "basicrta-7.0" / label
        d.mkdir(parents=True)
        _gibbs_pickle(d / "gibbs_590.pkl", rng, label=label, S=S, K=K,
                      n=2000)


def test_process_protein_over_reference_tree(tmp_path, rng):
    """A reference results tree (``gibbs_{niter}.pkl`` per residue) drives
    ``ProcessProtein`` collect / reprocess / get_taus on the CPU; the
    collected paths and loaded chains are the JAX package's."""
    _reference_tree(tmp_path, rng)
    kw = dict(ncomp=5, niter=590, g=10, burnin=100, gmm_n_init=8)
    pp = ProcessProtein(cfg=GibbsConfig(**kw), cutoff=7.0,
                        root=str(tmp_path), device="cpu")
    jpp = JProcessProtein(cfg=JConfig(**kw), cutoff=7.0, root=str(tmp_path))
    found = pp.collect_results()
    assert found == jpp.collect_results()
    assert list(found) == ["W5", "L8"]
    assert all(p is not None and p.endswith(".pkl") for p in found.values())
    pp.reprocess()
    taus, bars = pp.get_taus()
    assert taus.shape == (2,) and np.all(np.isfinite(taus))
    assert np.all(taus > 0) and np.all(bars >= 0)


def test_npz_is_preferred_over_the_pkl(tmp_path, rng):
    _reference_tree(tmp_path, rng, labels=("W5",))
    g = Gibbs.load(str(tmp_path / "basicrta-7.0" / "W5" / "gibbs_590.pkl"))
    g.save()
    pp = ProcessProtein(cfg=GibbsConfig(niter=590), cutoff=7.0,
                        root=str(tmp_path), device="cpu")
    assert pp.collect_results()["W5"].endswith("gibbs_590.npz")


def test_map_kinetics_from_pickles(tmp_path, rng):
    """``MapKinetics`` takes the reference's event table as a ``.pkl`` and
    a ``Gibbs`` from the reference's chain pickle: the frame table equals
    the one from the same events as ContactEvents, and the JAX
    package's from the same pickles on the same clusters."""
    from basicrta_tpu.kinetics.mapper import MapKinetics as JMapKinetics
    from basicrta_tpu.sampler.gibbs import Gibbs as JGibbs
    from basicrta_torch.kinetics.mapper import MapKinetics
    K, S = 4, 40
    times = np.round(rng.exponential(0.6, 30), 1) + 0.1
    rows = np.stack([np.full(30, 5), np.full(30, 900),
                     np.round(np.cumsum(times + 0.5), 1), times], 1)
    p = _event_pickle(tmp_path, rng, rows=rows)
    d = tmp_path / "basicrta-7.0" / "W5"
    d.mkdir(parents=True)
    mods, Gibbs_ref, Results, _ = _fake_modules()
    try:
        gr = Gibbs_ref()
        gr.times, gr.residue, gr.cutoff, gr.ts = times, "W5", 7.0, 0.1
        gr.ncomp, gr.niter, gr.g, gr.burnin = K, S * 10, 10, 100
        gr.mcweights = rng.dirichlet(np.ones(K), S)
        gr.mcrates = rng.gamma(2.0, 1.0, (S, K))
        _dump(gr, str(d / "gibbs_400.pkl"))
    finally:
        _cleanup(mods)
    g = Gibbs.load(str(d / "gibbs_400.pkl"))
    g.process_gibbs(save=False, device="cpu")
    mk = MapKinetics(g, p, device="cpu")
    assert mk.meta.cutoff == 7.0 and mk.meta.top == "top.gro"
    table = mk.frame_table()
    events = legacy.load_reference_contacts(p)
    np.testing.assert_array_equal(
        table, MapKinetics(g, events, device="cpu").frame_table())
    jg = JGibbs.load(str(d / "gibbs_400.pkl"))
    jg.processed, jg.parameters, jg.intervals = (g.processed, g.parameters,
                                                 g.intervals)
    np.testing.assert_allclose(table, JMapKinetics(jg, p).frame_table(),
                               rtol=1e-6)


def test_cli_cluster_and_kinetics_over_reference_pickles(tmp_path, rng,
                                                         monkeypatch):
    """``cluster`` over a reference tree and ``kinetics --gibbs ...pkl
    --contacts ...pkl --device cpu`` through the CLI, unchanged: the
    migrated residues are post-processed on the CPU when asked."""
    from basicrta_torch.io.native import XTCWriter
    from basicrta_torch.io.topology import Topology, write_gro
    # a trajectory for kinetics: protein residue 5 (4 atoms) and lipid 900
    F, A, n = 400, 8, 60
    top = Topology(np.array(["CA"] * 4 + ["C1"] * 4),
                   np.array([5] * 4 + [900] * 4, np.int32),
                   np.array(["TRP"] * 4 + ["CHOL"] * 4),
                   np.zeros((A, 3), np.float32),
                   np.array([50.0, 50.0, 50.0], np.float32))
    gro = write_gro(str(tmp_path / "top.gro"), top)
    pos = rng.uniform(10, 40, (F, A, 3)).astype(np.float32)
    with XTCWriter(str(tmp_path / "traj.xtc")) as w:
        w.write(pos, np.arange(F) * 0.1, np.tile([50.0, 50.0, 50.0], (F, 1)))
    times = np.round(rng.exponential(0.3, n), 1) + 0.1
    starts = np.round(np.arange(n) * 0.6, 1)
    rows = np.stack([np.full(n, 5), np.full(n, 900), starts, times], 1)
    p = _event_pickle(tmp_path, rng, top=gro, traj=str(tmp_path /
                                                        "traj.xtc"),
                      rows=rows)
    d = tmp_path / "basicrta-7.0" / "W5"
    d.mkdir(parents=True)
    mods, Gibbs_ref, _, _ = _fake_modules()
    try:
        gr = Gibbs_ref()
        gr.times, gr.residue, gr.cutoff, gr.ts = times, "W5", 7.0, 0.1
        gr.ncomp, gr.niter, gr.g, gr.burnin = 3, 300, 10, 50
        gr.mcweights = rng.dirichlet([8.0, 1.0, 1.0], 30)
        gr.mcrates = rng.gamma(2.0, 1.0, (30, 3))
        _dump(gr, str(d / "gibbs_300.pkl"))
    finally:
        _cleanup(mods)
    monkeypatch.chdir(tmp_path)
    cli.main(["cluster", "--cutoff", "7.0", "--niter", "300",
              "--engine", "torch"])
    table = np.load(tmp_path / "tausout.npy")
    assert table.shape == (1, 4) and table[0, 0] == 5
    assert np.isfinite(table[0, 1])
    os.remove(d / "gibbs_300.npz")     # cluster saved the processed state
    cli.main(["kinetics", "--gibbs", str(d / "gibbs_300.pkl"),
              "--contacts", p, "--device", "cpu"])
    assert (d / "traj_all.xtc").exists()
