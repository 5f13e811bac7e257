"""basicrta_torch.kinetics and io.dx against the JAX package, on the CPU.

Each input is made once from a numpy seed and goes through both packages.
Exact (``np.array_equal`` or the same bytes): the bin layout, the DX
writer, event frame ranges, the per-event membership probabilities and
the frame table (in RAM and memmapped) from one ``gibbs_*.npz`` both
packages load, the reduced trajectories in xtc, trr and dcd, and the loud
errors. To a tolerance (rtol 1e-5 of a grid's largest value, the card's
f32 atomics sum in another order): the weighted grids, against the JAX
package's and ``np.histogramdd``, with atoms on voxel edges and outside
the grid (same spill, same warning), and the ragged-mask case. Then the
``kinetics`` CLI of both packages on one toy ``.gro`` + ``.xtc``."""

import os
import shutil
import warnings

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, see conftest)
import numpy as np
import pytest
import torch

from basicrta_tpu import cli as jcli
from basicrta_tpu.io import dx as jdx
from basicrta_tpu.kinetics import density as jden
from basicrta_tpu.kinetics import mapper as jmap
from basicrta_tpu.ops import surv as jsurv
from basicrta_tpu.sampler.gibbs import Gibbs as JGibbs
from basicrta_torch import cli
from basicrta_torch.config import ContactConfig, GibbsConfig
from basicrta_torch.contacts.mapper import MapContacts, ProcessContacts
from basicrta_torch.contacts.records import ContactEvents, ContactMeta
from basicrta_torch.io import dx
from basicrta_torch.io.native import XTCWriter
from basicrta_torch.io.topology import Topology, write_gro
from basicrta_torch.io.universe import Universe
from basicrta_torch.kinetics import density as den
from basicrta_torch.kinetics import mapper
from basicrta_torch.ops import surv
from basicrta_torch.sampler.gibbs import Gibbs


def _grid_close(a, b):
    """rtol 1e-5 of the grid's largest value."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-5 * max(np.abs(b).max(), 1e-30))


def _make_system(root, ragged=False, seed=42, F=400, ts=0.1):
    """A residue W5 (2 atoms) and CHOL 100 (2 atoms) binding in windows of
    mixed length; ``ragged`` adds a 1-atom ION 200 that binds too. Writes
    ``top.gro`` + ``traj.xtc``, scans contacts with the port on the CPU,
    samples and processes W5 with the port's plain engine and saves it.
    Returns (gro, xtc, events path, gibbs path)."""
    rng = np.random.default_rng(seed)
    if ragged:
        names = np.array(["CA", "CB", "C1", "C2", "NA"])
        resids = np.array([5, 5, 100, 100, 200], np.int32)
        resnames = np.array(["TRP", "TRP", "CHOL", "CHOL", "ION"])
    else:
        names = np.array(["CA", "CB", "C1", "C2", "C1", "C2"])
        resids = np.array([5, 5, 100, 100, 101, 101], np.int32)
        resnames = np.array(["TRP", "TRP", "CHOL", "CHOL", "CHOL", "CHOL"])
    n = len(names)
    top = Topology(names, resids, resnames, np.zeros((n, 3), np.float32),
                   np.array([60.0] * 3, np.float32))
    pos = np.zeros((F, n, 3), np.float32)
    pos[:, 0:2] = [10.0, 10.0, 10.0]
    pos[:, 1, 0] = 11.0
    pos[:, 2:4] = [40.0, 40.0, 40.0]
    pos[:, 4:] = [50.0, 50.0, 50.0]
    f, state = 0, False
    while f < F - 30:
        length = int(rng.integers(1, 25))
        if state:
            if ragged and rng.random() < 0.5:
                pos[f:f + length, 4] = [12.0, 10.0, 10.0]
            else:
                pos[f:f + length, 2:4] = [13.0, 10.0, 10.0]
                # a little spread, so grids have more than one voxel
                pos[f:f + length, 3] += rng.normal(0, 1.5, (length, 3))
        state = not state
        f += length
    os.makedirs(root, exist_ok=True)
    gro = write_gro(os.path.join(root, "top.gro"), top)
    xtc = os.path.join(root, "traj.xtc")
    XTCWriter(xtc).write(pos, np.arange(F) * ts,
                         np.tile([60.0] * 3, (F, 1)))
    sel2 = "resname CHOL ION" if ragged else "resname CHOL"
    u = Universe(gro, xtc)
    i1, i2 = u.select_atoms("protein"), u.select_atoms(sel2)
    meta = ContactMeta(top=gro, traj=xtc, sel1="protein", sel2=sel2, ts=ts)
    rec = MapContacts(i1, u.topology.resids[i1], i2, u.topology.resids[i2],
                      cfg=ContactConfig(map_cutoff=10.0), meta=meta,
                      device="cpu").run(u.iter_batches(64))
    events = ProcessContacts(7.0).run(rec)
    epath = os.path.join(root, "contacts_7.0.npz")
    events.save(epath)
    cfg = GibbsConfig(ncomp=3, niter=600, g=10, burnin=200, gmm_n_init=4,
                      seed=0, n_chains=1)
    g = Gibbs(events.times_for_residue(5), residue="W5", cutoff=7.0,
              cfg=cfg, root=root)
    g.run(engine="torch", save=False)
    g.process_gibbs(save=False)
    return gro, xtc, epath, g.save()


def _twin(gpath, root):
    """A copy of the results tree under ``root``: (port Gibbs, JAX Gibbs)
    load the same file, each package writing into its own tree."""
    d = os.path.join(root, "basicrta-7.0", "W5")
    os.makedirs(d, exist_ok=True)
    shutil.copy(gpath, d)
    p = os.path.join(d, os.path.basename(gpath))
    return Gibbs.load(p), JGibbs.load(p)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("kin"))
    return base, _make_system(os.path.join(base, "src"))


@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ragged"))
    return base, _make_system(os.path.join(base, "src"), ragged=True)


def _pair(system, name, **kw):
    """(port MapKinetics, JAX MapKinetics) on the same artifacts, each in
    its own results tree ``name``."""
    base, (_, _, epath, gpath) = system
    g, jg = _twin(gpath, os.path.join(base, name, "torch"))
    _, jg = _twin(gpath, os.path.join(base, name, "jax"))
    return (mapper.MapKinetics(g, epath, device="cpu", **kw),
            jmap.MapKinetics(jg, epath, **kw))


# ---------------------------------------------------------------- exact
@pytest.mark.parametrize("delta,lo,hi", [
    (1.0, [0.25, -3.0, 7.0], [9.75, 3.0, 47.5]),
    (0.5, [-20.0, -20.0, -20.0], [20.0, 20.0, 20.0]),
    (0.3, [1.1, 2.2, 3.3], [4.4, 9.9, 3.4])])
def test_fixedwidth_bins_equal_jax(delta, lo, hi):
    a = den.fixedwidth_bins(delta, np.array(lo), np.array(hi))
    b = jden.fixedwidth_bins(delta, np.array(lo), np.array(hi))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape,origin,delta", [
    ((5, 6, 7), [1.0, 2.0, 3.0], 1.0),
    ((4, 4, 5), [-12.5, 0.25, 1e-3], [0.5, 0.25, 2.0]),
    ((1, 2, 1), [0.0, 0.0, 0.0], 0.1)])
def test_write_dx_same_bytes(tmp_path, shape, origin, delta):
    grid = np.random.default_rng(shape[0]).lognormal(0.0, 4.0, shape)
    grid.flat[0] = 0.0
    a = dx.write_dx(str(tmp_path / "a.dx"), grid, origin, delta)
    b = jdx.write_dx(str(tmp_path / "b.dx"), grid, origin, delta)
    assert open(a, "rb").read() == open(b, "rb").read()
    for x, y in zip(dx.read_dx(a), jdx.read_dx(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ts", [0.1, 0.25, 1.0, 0.002])
def test_start_stop_frames_equal_jax(ts):
    rng = np.random.default_rng(int(ts * 1000))
    k0 = rng.integers(0, 5000, 400)
    k1 = rng.integers(1, 300, 400)
    starts, durs = k0 * ts, k1 * ts
    # 0.3 / 0.1 = 2.999...: rounding, not truncation, makes it 3 frames
    starts[:3] = [0.3, 0.7, 2.9]
    durs[:3] = [0.3, 0.6, 0.1]
    a = surv.start_stop_frames(starts, durs, ts)
    b = jsurv.start_stop_frames(starts, durs, ts)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    if ts == 0.1:
        np.testing.assert_array_equal(a[0][:3], [3, 7, 29])
        np.testing.assert_array_equal(a[1][:3] - a[0][:3] + 1, [3, 6, 1])


def test_survival_helpers_equal_jax():
    rng = np.random.default_rng(8)
    x = np.round(rng.exponential(3.0, 700), 1) + 0.1
    np.testing.assert_array_equal(surv.survival_bins(x, 0.1),
                                  jsurv.survival_bins(x, 0.1))
    for a, b in zip(surv.survival_function(x, 0.1),
                    jsurv.survival_function(x, 0.1)):
        np.testing.assert_array_equal(a, b)
    R = rng.lognormal(0.0, 1.0, (200, 5))
    R[:, 3] = R[:, 2] * 1.001
    assert surv.unique_rate_count(5, R) == jsurv.unique_rate_count(5, R)


def test_pindicator_per_event_equal_jax(system):
    _, (_, _, _, gpath) = system
    a, b = Gibbs.load(gpath), JGibbs.load(gpath)
    pa, pb = a.pindicator_per_event(), b.pindicator_per_event()
    assert pa.shape == (len(a.times), a.processed.lmode)
    np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("memmap", [False, True])
def test_frame_table_equal_jax(system, memmap):
    mk, jmk = _pair(system, f"table_{memmap}")
    a = mk.frame_table(memmap=memmap, event_chunk=3)
    b = jmk.frame_table(memmap=memmap, event_chunk=3)
    assert isinstance(a, np.memmap) == memmap
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert a.shape[0] > 50 and a.shape[1] == 2 + mk.gibbs.processed.lmode
    if memmap:
        name = "den_write_data.npy"
        ra = np.load(os.path.join(mk.savedir, name))
        rb = np.load(os.path.join(jmk.savedir, name))
        np.testing.assert_array_equal(ra, rb)
        assert open(os.path.join(mk.savedir, name), "rb").read(128) == \
            open(os.path.join(jmk.savedir, name), "rb").read(128)


def test_frame_table_auto_memmap_above_the_row_limit(system, monkeypatch):
    mk, jmk = _pair(system, "auto_memmap")
    monkeypatch.setattr(mapper.MapKinetics, "MEMMAP_ROWS", 10)
    monkeypatch.setattr(jmap.MapKinetics, "MEMMAP_ROWS", 10)
    a, b = mk.frame_table(), jmk.frame_table()
    assert isinstance(a, np.memmap) and isinstance(b, np.memmap)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_files(a, b):
    assert [os.path.basename(p) for p in a] == \
        [os.path.basename(p) for p in b]
    for p, q in zip(a, b):
        assert open(p, "rb").read() == open(q, "rb").read(), p


@pytest.mark.parametrize("fmt", ["xtc", "trr", "dcd"])
def test_reduced_trajectories_same_bytes(system, fmt):
    mk, jmk = _pair(system, f"traj_{fmt}", traj_format=fmt)
    _same_files(mk.create_traj(top_n=7), jmk.create_traj(top_n=7))
    _same_files(mk.create_traj(), jmk.create_traj())
    _same_files(mk.write_component_trajs(), jmk.write_component_trajs())
    _same_files(mk.write_component_trajs(step=3),
                jmk.write_component_trajs(step=3))
    # reduced.gro: the same atoms and coordinates; its title line names
    # the package that wrote it
    gro_a, gro_b = (open(os.path.join(m.savedir, "reduced.gro")).read()
                    .split("\n", 1) for m in (mk, jmk))
    assert gro_a[1] == gro_b[1] and gro_a[0].startswith("basicrta_torch")
    with pytest.raises(FileExistsError):
        mk.create_traj()


def test_heterogeneous_sel2_trajectory_is_loud(ragged):
    mk, jmk = _pair(ragged, "loud_traj")
    for m in (mk, jmk):
        with pytest.raises(ValueError, match="differing atom counts"):
            m.create_traj()


def test_event_table_mismatch_is_loud(ragged):
    base, (_, _, epath, gpath) = ragged
    ev = ContactEvents.load(epath)
    trunc = ContactEvents(ev.sel1_resids[:-1], ev.sel2_resids[:-1],
                          ev.start_times[:-1], ev.durations[:-1], ev.meta)
    g, _ = _twin(gpath, os.path.join(base, "mismatch"))
    with pytest.raises(ValueError, match="different "):
        mapper.MapKinetics(g, trunc, device="cpu").frame_table()


@pytest.mark.parametrize("label,resid", [("W313", 313), ("313", 313),
                                         (313, 313), ("HSD42", 42)])
def test_resid_parse_equal_jax(label, resid):
    assert mapper._resid_of(label) == jmap._resid_of(label) == resid


def test_resid_parse_and_inputs_are_loud(system):
    with pytest.raises(ValueError, match="residue id"):
        mapper._resid_of("XYZ")
    base, (_, _, epath, gpath) = system
    g, _ = _twin(gpath, os.path.join(base, "inputs"))
    with pytest.raises(ValueError, match="traj_format"):
        mapper.MapKinetics(g, epath, traj_format="pdb", device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        mapper.MapKinetics(g, "contacts_7.0.pkl", device="cpu")


# ------------------------------------------------------------ allclose
def _histogramdd(pos, w, edges, mask=None):
    bins = [len(e) - 1 for e in edges]
    rng_ = [(e[0], e[-1]) for e in edges]
    out = np.zeros((w.shape[1], *bins))
    for f in range(len(pos)):
        keep = slice(None) if mask is None else mask[f] > 0
        h, _ = np.histogramdd(pos[f][keep], bins=bins, range=rng_)
        out += h[None] * w[f][:, None, None, None]
    return out


def _both(fn_t, fn_j):
    """Run both with warnings recorded; return results and messages."""
    out = []
    for fn in (fn_t, fn_j):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            r = fn()
        out.append((r, [str(w.message) for w in rec]))
    return out


@pytest.mark.parametrize("case", ["inside", "edges", "outside", "ragged"])
def test_weighted_histogram_equal_jax(case):
    rng = np.random.default_rng(["inside", "edges", "outside",
                                 "ragged"].index(case))
    F, A, K = 24, 30, 3
    pos = rng.uniform(1, 39, (F, A, 3)).astype(np.float32)
    mask = None
    if case == "edges":
        # exactly on voxel edges, the grid's faces and just inside them
        pos[:, :12] = rng.integers(0, 41, (F, 12, 3)).astype(np.float32)
        pos[0, :4] = [[0, 0, 0], [40, 40, 40], [39.999998, 0, 20],
                      [-1e-6, 20, 20]]
    if case == "outside":
        pos[:, :5] += rng.choice([-60.0, 60.0], (F, 5, 3)).astype(np.float32)
    if case == "ragged":
        mask = (rng.random((F, A)) < 0.7).astype(np.float32)
        pos[mask == 0] = 1e4          # padded slots: ignored anywhere
    w = rng.uniform(0, 1, (F, K)).astype(np.float32)
    kw = dict(gridcenter=[20.0, 20.0, 20.0], xdim=40, ydim=40, zdim=40,
              delta=1.0, frame_chunk=7, mask=mask)
    (a, wa), (b, wb) = _both(
        lambda: den.weighted_histogram_3d(pos, w, device="cpu", **kw),
        lambda: jden.weighted_histogram_3d(pos, w, **kw))
    # the upper face (40) is outside [0, 40): edges spill too
    assert wa == wb and (len(wa) == 1) == (case in ("outside", "edges"))
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    for k in range(K):
        _grid_close(a[0][k], b[0][k])
    if case != "edges":      # histogramdd puts the upper face inside
        ref = _histogramdd(pos, w, a[1], mask)
        for k in range(K):
            _grid_close(a[0][k], ref[k])


def test_out_of_grid_fraction_and_grid_from_positions():
    pos = np.array([[[100.0, 100.0, 100.0], [5.0, 5.0, 5.0]]], np.float32)
    with pytest.warns(UserWarning, match="50.0%.*outside"):
        grids, _ = den.weighted_histogram_3d(
            pos, np.ones((1, 1), np.float32), gridcenter=[5.0] * 3,
            xdim=10, ydim=10, zdim=10, device="cpu")
    assert grids.sum() == pytest.approx(1.0)
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 10, (6, 8, 3)).astype(np.float32)
    w = rng.uniform(0, 1, 6).astype(np.float32)
    (a, wa), (b, wb) = _both(
        lambda: den.weighted_histogram_3d(p, w, delta=0.7, device="cpu"),
        lambda: jden.weighted_histogram_3d(p, w, delta=0.7))
    assert wa == wb == []
    _grid_close(a[0], b[0])


@pytest.mark.parametrize("delta", [0.5, 1.0])
def test_wdensity_equal_jax(delta):
    rng = np.random.default_rng(int(delta * 10))
    pos = rng.uniform(0, 10, (9, 5, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (9, 2)).astype(np.float32)
    kw = dict(gridcenter=[5.0] * 3, xdim=10, ydim=10, zdim=10, delta=delta)
    a = den.WDensity(pos, w, device="cpu", **kw)
    b = jden.WDensity(pos, w, **kw)
    for da, db in zip(a.densities, b.densities):
        _grid_close(da.grid, db.grid)
        np.testing.assert_array_equal(da.origin, db.origin)
        np.testing.assert_array_equal(da.delta, db.delta)
        assert da.density_unit == db.density_unit
        da.convert_density("TIP3P")
        db.convert_density("TIP3P")
        _grid_close(da.grid, db.grid)


def test_grid_accumulator_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        den.GridAccumulator(1, [0.0] * 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        den.weighted_histogram_3d(np.zeros((1, 1, 3), np.float32),
                                  np.ones((1, 1), np.float32))


def _read_all(paths):
    return {os.path.basename(p): dx.read_dx(p) for p in paths}


def _dx_close(a, b):
    assert sorted(a) == sorted(b) and a
    for name in a:
        (ga, oa, da), (gb, ob, db) = a[name], b[name]
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(da, db)
        _grid_close(ga, gb)


@pytest.mark.parametrize("kw", [{}, dict(top_n=10), dict(step=2, filterP=0.2),
                                dict(gridcenter=[13.0, 10.0, 10.0],
                                     xdim=20.0, ydim=20.0, zdim=10.0,
                                     delta=0.5)])
def test_weighted_densities_equal_jax(system, kw):
    mk, jmk = _pair(system, f"wden_{len(kw)}_{kw.get('top_n')}")
    _dx_close(_read_all(mk.weighted_densities(frame_chunk=13, **kw)),
              _read_all(jmk.weighted_densities(frame_chunk=13, **kw)))


def test_ragged_densities_mask_equal_jax(ragged):
    mk, jmk = _pair(ragged, "ragged_wden")
    a = _read_all(mk.weighted_densities())
    _dx_close(a, _read_all(jmk.weighted_densities()))
    # mass: each row adds its weight times its live atoms
    table = mk.frame_table()
    atoms = np.where(table[:, 1] == 100, 2, 1)
    expected = (table[:, 2:] * atoms[:, None]).sum()
    total = sum(g.sum() * np.prod(d) * len(table) for g, _, d in a.values())
    assert total == pytest.approx(expected, rel=1e-4)


def test_contact_positions_equal_jax(ragged):
    mk, jmk = _pair(ragged, "ragged_pos")
    u = mk._open_universe()
    i2 = u.select_atoms("resname CHOL ION")
    r2 = u.topology.resids[i2]
    table = mk.frame_table()
    fr, lp = table[:, 0].astype(int), table[:, 1].astype(int)
    for a, b in zip(mk._contact_positions(u, i2, r2, fr, lp),
                    jmk._contact_positions(u, i2, r2, fr, lp)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ----------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def cli_runs(system, tmp_path_factory):
    """Both CLIs' ``kinetics --wdensity --comp-trajs --top_n 6`` on the
    same artifacts: {'torch' | 'jax': (printed paths, results dir)}."""
    base, (_, _, epath, gpath) = system
    out = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        root = str(tmp_path_factory.mktemp(f"cli_kin_{name}"))
        g, _ = _twin(gpath, root)
        argv = ["kinetics", "--gibbs", os.path.join(g.savedir, os.path.
                                                    basename(gpath)),
                "--contacts", epath, "--wdensity", "--comp-trajs",
                "--top_n", "6", *extra]
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        out[name] = ([ln.split()[-1] for ln in buf.getvalue().splitlines()
                      if ln.startswith("wrote ")], g.savedir)
    return out


def test_kinetics_cli_equal_jax(cli_runs):
    (pa, _), (pb, _) = cli_runs["torch"], cli_runs["jax"]
    assert [os.path.basename(p) for p in pa] == \
        [os.path.basename(p) for p in pb]
    trajs = [(p, q) for p, q in zip(pa, pb) if not p.endswith(".dx")]
    assert len(trajs) >= 2
    _same_files(*zip(*trajs))
    dxs = [(p, q) for p, q in zip(pa, pb) if p.endswith(".dx")]
    assert dxs
    _dx_close(_read_all([p for p, _ in dxs]), _read_all([q for _, q in dxs]))


def test_kinetics_cli_cuda_raises_without_a_card(system, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    base, (_, _, epath, gpath) = system
    g, _ = _twin(gpath, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["kinetics", "--gibbs", os.path.join(
            g.savedir, os.path.basename(gpath)), "--contacts", epath,
            "--wdensity"])
    assert not any(f.endswith((".xtc", ".dx"))
                   for f in os.listdir(g.savedir))
