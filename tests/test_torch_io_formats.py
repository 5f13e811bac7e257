"""The port's Amber, NetCDF, inpcrd, multi-model PDB and PSF + TRR paths
against the JAX package's, on the cases of ``tests/test_io.py``
(``TestAmber``, the NetCDF cases of ``TestTrajectoryWriterFacade``,
``TestInpcrd``, ``TestPDBModels``, ``TestReviewRegressions``,
``TestChainReader``, ``TestPropSelections::test_mass_guess`` and
``TestPSF::test_psf_trr_contacts``).

Host code on the same files, so everything is exact: a NetCDF file
written by either package's writer reads back through both readers with
frames, times and boxes equal bit for bit, and its variables equal those
of the other package's file; every reader gives equal arrays on the JAX
tests' fixtures; an error path raises the same type with the same
message in both; contact rows and events of the port on the CPU equal
the JAX package's."""

import os

import numpy as np
import pytest

import test_io as jt   # the JAX package's I/O tests: fixtures and writers

from basicrta_tpu.config import ContactConfig as JConfig
from basicrta_tpu.contacts import mapper as jm
from basicrta_tpu.contacts.records import ContactMeta as JMeta
from basicrta_tpu.io import amber as ja
from basicrta_tpu.io import native as jn
from basicrta_tpu.io import topology as jtop
from basicrta_tpu.io import universe as ju

from basicrta_torch.config import ContactConfig
from basicrta_torch.contacts import mapper as tm
from basicrta_torch.contacts.records import ContactMeta
from basicrta_torch.io import amber as ta
from basicrta_torch.io import native as tn
from basicrta_torch.io import topology as ttop
from basicrta_torch.io import universe as tu

from test_torch_io import _assert_batches, _assert_topologies

PKGS = {"torch": (ta, tn, ttop, tu), "jax": (ja, jn, jtop, ju)}


def _same(a, b):
    """Equal nested tuples of arrays/None, bit for bit and dtype."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _raise_alike(make, exc, match):
    """``make(pkg)`` raises ``exc`` matching ``match`` in both packages,
    with the same message."""
    msgs = []
    for pkg in ("torch", "jax"):
        with pytest.raises(exc, match=match) as e:
            make(pkg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _frames(rng, F=5, A=9):
    coords = rng.uniform(0, 80, (F, A, 3)).astype(np.float32)
    return coords, np.arange(F) * 0.1, np.tile([50.0, 50.0, 50.0], (F, 1))


def _triclinic(F):
    return jtop.box_from_cosines(
        np.full(F, 60.0), np.full(F, 55.0), np.full(F, 48.0),
        np.full(F, np.cos(np.radians(80.0))),
        np.full(F, np.cos(np.radians(95.0))),
        np.full(F, np.cos(np.radians(101.0))))


# ------------------------------- NetCDF ------------------------------------ #

def _nc_variables(path):
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "r", mmap=False)
    try:
        out = {k: (v[:].copy(), dict(v._attributes))
               for k, v in nc.variables.items()}
        attrs = {k: v for k, v in nc._attributes.items()
                 if k not in ("program", "title")}
        return out, attrs, dict(nc.dimensions)
    finally:
        nc.close()


@pytest.mark.parametrize("box", ["ortho", "triclinic", "none"])
def test_ncdf_written_by_either_reads_equal_in_both(tmp_path, rng, box):
    coords, times, ortho = _frames(rng)
    B = {"ortho": ortho, "triclinic": _triclinic(len(coords)),
         "none": None}[box]
    paths = {}
    for pkg, (_, nat, _, _) in PKGS.items():
        p = str(tmp_path / f"{pkg}.nc")
        with nat.trajectory_writer(p) as w:       # chunk-append contract
            w.write(coords[:2], times[:2], None if B is None else B[:2])
            w.write(coords[2:], times[2:], None if B is None else B[2:])
        paths[pkg] = p
    # the files differ only in the program's name and title
    vt, at, dt = _nc_variables(paths["torch"])
    vj, aj, dj = _nc_variables(paths["jax"])
    assert at == aj and dt == dj and sorted(vt) == sorted(vj)
    for k in vt:
        _same(vt[k][0], vj[k][0])
        assert vt[k][1] == vj[k][1], k
    reads = {(w, r): PKGS[r][0].NCDFReader(paths[w]).read([3, 0, 4])
             for w in PKGS for r in PKGS}
    first = reads[("torch", "torch")]
    for got in reads.values():
        _same(got, first)
    c, t, b = first
    np.testing.assert_array_equal(c, coords[[3, 0, 4]])
    np.testing.assert_allclose(t, times[[3, 0, 4]], atol=1e-6)
    if box == "none":
        assert b is None
    elif box == "ortho":
        assert b.shape == (3, 3) and np.allclose(b, 50.0)
    else:
        assert b.shape == (3, 3, 3)
        np.testing.assert_allclose(b, B[[3, 0, 4]], atol=1e-3)


@pytest.mark.parametrize("case", ["times_box", "triclinic_no_times",
                                  "no_box"])
def test_ncdf_fixtures_read_equal(tmp_path, rng, case):
    """The hand-written files of ``TestAmber`` (scipy's writer, not either
    package's): equal arrays through both readers, full and by index."""
    coords = rng.uniform(0, 80, (4, 9, 3)).astype(np.float32)
    kw = {"times_box": dict(times_ps=np.arange(4) * 100.0,
                            lengths=np.tile([90.0] * 3, (4, 1))),
          "triclinic_no_times": dict(
              lengths=np.tile([60.0] * 3, (4, 1)),
              angles=np.tile([70.5, 109.5, 70.5], (4, 1))),
          "no_box": dict(times_ps=np.arange(4) * 2.0)}[case]
    path = jt._write_ncdf(tmp_path / "t.nc", coords, **kw)
    rt, rj = ta.NCDFReader(path), ja.NCDFReader(path)
    assert (rt.natoms, len(rt)) == (rj.natoms, len(rj)) == (9, 4)
    _same(rt.read(), rj.read())
    _same(rt.read([3, 1]), rj.read([3, 1]))
    rt.close()
    rj.close()


def test_ncdf_errors_alike(tmp_path, rng):
    coords, times, box = _frames(rng)
    path = jt._write_ncdf(tmp_path / "u.nc", coords[:2],
                          conventions="SOMETHING")
    for R in (ta.NCDFReader, ja.NCDFReader):
        with pytest.warns(UserWarning, match="AMBER"):
            R(path)
    (tmp_path / "h.nc").write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    _raise_alike(lambda p: PKGS[p][0].NCDFReader(str(tmp_path / "h.nc")),
                 ValueError, "NetCDF-4")

    def mixed(pkg):
        w = PKGS[pkg][1].trajectory_writer(str(tmp_path / f"{pkg}.nc"))
        w.write(coords[:2], times[:2], box[:2])
        w.write(coords[2:], times[2:], None)
    _raise_alike(mixed, ValueError, "agree on having a box")

    def after_close(pkg):
        w = PKGS[pkg][1].trajectory_writer(str(tmp_path / f"c{pkg}.nc"))
        w.write(coords, times, box)
        w.close()
        w.write(coords, times, box)
    _raise_alike(after_close, ValueError, "after close")
    _raise_alike(lambda p: PKGS[p][1].trajectory_writer(
        str(tmp_path / "a.pdb")), ValueError, "no trajectory writer")
    assert tn.TRAJ_WRITE_FORMATS == jn.TRAJ_WRITE_FORMATS
    for ext in tn.TRAJ_WRITE_FORMATS:
        a = tn.trajectory_writer(str(tmp_path / f"d.{ext}"))
        b = jn.trajectory_writer(str(tmp_path / f"d.{ext}"))
        assert type(a).__name__ == type(b).__name__


def test_ncdf_convention_labels_equal(tmp_path, rng):
    from scipy.io import netcdf_file
    coords, times, box = _frames(rng)
    for pkg, (_, nat, _, _) in PKGS.items():
        path = str(tmp_path / f"{pkg}.nc")
        with nat.trajectory_writer(path) as w:
            w.write(coords, times, box)
        nc = netcdf_file(path, "r", mmap=False)
        assert nc.variables["spatial"][:].tobytes() == b"xyz"
        assert nc.variables["cell_spatial"][:].tobytes() == b"abc"
        assert nc.variables["cell_angular"][:].tobytes() == \
            b"alphabeta gamma"
        assert nc.program == {"torch": b"basicrta_torch",
                              "jax": b"basicrta_tpu"}[pkg]
        nc.close()


def test_ncdf_universe_batches_equal(tmp_path, rng):
    coords, times, box = _frames(rng, F=7)
    top = ttop.Topology(np.array([f"C{i}" for i in range(9)]),
                        np.ones(9, np.int32), np.array(["LIG"] * 9),
                        positions=coords[0],
                        box=np.array([50.0] * 3, np.float32))
    gro = ttop.write_gro(str(tmp_path / "u.gro"), top)
    nc = str(tmp_path / "u.nc")
    with tn.trajectory_writer(nc) as w:
        w.write(coords, times, box)
    a, b = tu.Universe(gro, nc), ju.Universe(gro, nc)
    assert a.n_frames == b.n_frames == 7
    assert a.timestep_ns() == b.timestep_ns()
    _assert_batches(list(a.iter_batches(3)), list(b.iter_batches(3)))


# ------------------------------- prmtop ------------------------------------ #

def test_prmtop_parse_and_refusal(tmp_path):
    p = tmp_path / "t.prmtop"
    p.write_text(jt.PRMTOP_TEXT)
    a, b = ta.read_prmtop(str(p)), ja.read_prmtop(str(p))
    _assert_topologies(a, b)
    assert list(np.unique(a.resnames)) == ["ALA", "CHOL", "TRP"]
    q = tmp_path / "x.prmtop"
    q.write_text("not a prmtop\n")
    _raise_alike(lambda pkg: PKGS[pkg][0].read_prmtop(str(q)), ValueError,
                 "VERSION")


# ------------------------------- mdcrd ------------------------------------- #

def test_mdcrd_box_detection_equal(tmp_path, rng):
    coords = rng.uniform(-150, 150, (5, 9, 3)).astype(np.float32)
    box = np.tile([90.0, 90.0, 90.0], (5, 1)).astype(np.float32)
    plain = jt._write_mdcrd(tmp_path / "p.mdcrd", coords)
    boxed = jt._write_mdcrd(tmp_path / "b.mdcrd", coords, box)
    for path, has_box in ((plain, False), (boxed, True)):
        rt, rj = ta.MDCRDReader(path, 9), ja.MDCRDReader(path, 9)
        assert rt.has_box == rj.has_box == has_box
        assert len(rt) == len(rj) == 5
        _same(rt.read(), rj.read())
        _same(rt.read([4, 0]), rj.read([4, 0]))
    # 12 data lines: 3 frames boxed or 4 plain; the probe line decides
    b3 = jt._write_mdcrd(tmp_path / "b3.mdcrd", rng.uniform(0, 9, (3, 9, 3)),
                         np.tile([80.0] * 3, (3, 1)))
    p4 = jt._write_mdcrd(tmp_path / "p4.mdcrd", rng.uniform(0, 9, (4, 9, 3)))
    for path, n, has_box in ((b3, 3, True), (p4, 4, False)):
        rt, rj = ta.MDCRDReader(path, 9), ja.MDCRDReader(path, 9)
        assert (len(rt), rt.has_box) == (len(rj), rj.has_box) == (n, has_box)
        _same(rt.read(), rj.read())


def test_mdcrd_errors_alike(tmp_path, rng):
    path = jt._write_mdcrd(tmp_path / "t.mdcrd", rng.uniform(0, 9, (2, 9, 3)))
    lines = open(path).read().splitlines()
    (tmp_path / "bad.mdcrd").write_text("\n".join(lines[:-2]) + "\n")
    _raise_alike(lambda p: PKGS[p][0].MDCRDReader(
        str(tmp_path / "bad.mdcrd"), 9), ValueError, "box line|fit neither")
    one = jt._write_mdcrd(tmp_path / "one.mdcrd", np.zeros((2, 1, 3)),
                          np.tile([9.0] * 3, (2, 1)))
    _raise_alike(lambda p: PKGS[p][0].MDCRDReader(one, 1), ValueError,
                 "ambiguous")
    _same(ta.MDCRDReader(one, 1, has_box=True).read(),
          ja.MDCRDReader(one, 1, has_box=True).read())
    top = tmp_path / "t.prmtop"
    top.write_text(jt.PRMTOP_TEXT)
    (tmp_path / "empty.mdcrd").write_text("title only\n")
    _raise_alike(lambda p: PKGS[p][3].Universe(
        str(top), str(tmp_path / "empty.mdcrd")), ValueError, "no frames")


def test_mdcrd_universe_needs_dt(tmp_path, rng):
    top = tmp_path / "t.prmtop"
    top.write_text(jt.PRMTOP_TEXT)
    traj = jt._write_mdcrd(tmp_path / "t.mdcrd", rng.uniform(0, 9, (4, 9, 3)))
    _raise_alike(lambda p: PKGS[p][3].Universe(str(top), traj).timestep_ns(),
                 ValueError, "dt_ns")
    a = tu.Universe(str(top), traj, dt_ns=0.25)
    b = ju.Universe(str(top), traj, dt_ns=0.25)
    got = list(a.iter_batches(3))
    _assert_batches(got, list(b.iter_batches(3)))
    assert got[1].times[0] == pytest.approx(0.75) and got[0].box is None


# ------------------------------- inpcrd ------------------------------------ #

_INPCRD = jt.TestInpcrd()


@pytest.mark.parametrize("kind", ["plain", "boxed", "velocities_box",
                                  "triclinic"])
def test_inpcrd_variants_equal(tmp_path, rng, kind):
    coords = rng.uniform(-90, 90, (7, 3)).astype(np.float32)
    box = {"plain": None, "boxed": [80.0] * 3 + [90.0] * 3,
           "velocities_box": [80.0] * 3 + [90.0] * 3,
           "triclinic": [70.0] * 3 + [109.47] * 3}[kind]
    p = _INPCRD._write(tmp_path / "a.rst7", coords, box,
                       vel=kind == "velocities_box")
    rt, rj = ta.InpcrdReader(p), ja.InpcrdReader(p)
    assert (rt.natoms, len(rt)) == (rj.natoms, len(rj)) == (7, 1)
    _same(rt.read(), rj.read())
    c, b = rt.read()
    np.testing.assert_allclose(c[0], coords, atol=1e-6)
    assert (b is None) == (box is None)
    if kind == "triclinic":
        assert b.shape == (1, 3, 3)


def test_inpcrd_bad_count_alike(tmp_path, rng):
    p = _INPCRD._write(tmp_path / "x.rst7",
                       rng.uniform(0, 9, (5, 3)).astype(np.float32))
    txt = open(p).read().splitlines()
    (tmp_path / "bad.rst7").write_text("\n".join(txt[:-1]) + "\n")
    _raise_alike(lambda pkg: PKGS[pkg][0].InpcrdReader(
        str(tmp_path / "bad.rst7")), ValueError, "do not fit")


def test_inpcrd_universe_position_injection_equal(tmp_path):
    p = tmp_path / "t.prmtop"
    p.write_text(jt.PRMTOP_TEXT)
    pos = np.zeros((9, 3), np.float32)
    pos[0:5] = [10, 10, 10]
    pos[5:7] = [13, 10, 10]
    pos[7:9] = [60, 60, 60]
    rst = _INPCRD._write(tmp_path / "t.rst7", pos, [90.0] * 3 + [90.0] * 3)
    a, b = tu.Universe(str(p), rst), ju.Universe(str(p), rst)
    _assert_topologies(a.topology, b.topology)
    for sel in ("resname CHOL and around 5.0 protein", "prop x > 50"):
        np.testing.assert_array_equal(a.select_atoms(sel),
                                      b.select_atoms(sel))
    assert list(a.select_atoms("resname CHOL and around 5.0 protein")) == \
        [5, 6]
    _assert_batches(list(a.iter_batches(1)), list(b.iter_batches(1)))


# ---------------------------- multi-model PDB ------------------------------ #

def test_pdb_models_equal(tmp_path, rng):
    coords = rng.uniform(0, 90, (3, 7, 3)).astype(np.float32)
    path, _ = jt.TestPDBModels()._write_models(tmp_path / "m.pdb", coords,
                                               [90.0, 90.0, 90.0])
    rt, rj = ttop.PDBModelReader(path), jtop.PDBModelReader(path)
    assert (len(rt), rt.natoms) == (len(rj), rj.natoms) == (3, 7)
    _same(rt.read(), rj.read())
    _same(rt.read([2, 0]), rj.read([2, 0]))
    np.testing.assert_allclose(rt.read([2])[0][0], coords[2], atol=1e-3)
    a, b = tu.Universe(path, path, dt_ns=0.5), ju.Universe(path, path,
                                                           dt_ns=0.5)
    assert a.n_frames == b.n_frames == 3
    _assert_batches(list(a.iter_batches(2)), list(b.iter_batches(2)))
    _raise_alike(lambda p: PKGS[p][3].Universe(path, path).timestep_ns(),
                 ValueError, "dt_ns")


def test_pdb_single_model_and_mismatch(tmp_path, rng):
    coords = rng.uniform(0, 50, (4, 3)).astype(np.float32)
    top = ttop.Topology(np.array(["CA"] * 4), np.arange(4, dtype=np.int32)
                        + 1, np.array(["GLY"] * 4), coords)
    p = ttop.write_pdb(str(tmp_path / "s.pdb"), top)
    rt, rj = ttop.PDBModelReader(p), jtop.PDBModelReader(p)
    assert len(rt) == len(rj) == 1
    _same(rt.read(), rj.read())
    assert rt.read()[1] is None
    bad = tmp_path / "bad.pdb"
    bad.write_text(
        "MODEL 1\n"
        "ATOM      1 CA   ALA A   1      1.000   1.000   1.000  1.00  0.00\n"
        "ENDMDL\nMODEL 2\n"
        "ATOM      1 CA   ALA A   1      1.000   1.000   1.000  1.00  0.00\n"
        "ATOM      2 CB   ALA A   1      2.000   1.000   1.000  1.00  0.00\n"
        "ENDMDL\nEND\n")
    _raise_alike(lambda pkg: PKGS[pkg][2].PDBModelReader(str(bad)),
                 ValueError, "differing atom counts")


# ------------------------- chains and small helpers ------------------------ #

def test_mixed_format_chain_and_restarted_clock(tmp_path, rng):
    coords = rng.uniform(0, 50, (6, 12, 3)).astype(np.float32)
    box = np.tile([50.0] * 3, (6, 1))
    tn.XTCWriter(str(tmp_path / "a.xtc")).write(coords[:3],
                                                np.arange(3) * 0.1, box[:3])
    tn.DCDWriter(str(tmp_path / "b.dcd")).write(coords[3:], box[3:])
    top = ttop.Topology(np.array(["CA"] * 12), np.arange(12, dtype=np.int32),
                        np.array(["ALA"] * 12), coords[0])
    gro = ttop.write_gro(str(tmp_path / "t.gro"), top)
    chain = [str(tmp_path / "a.xtc"), str(tmp_path / "b.dcd")]
    _raise_alike(lambda p: PKGS[p][3].Universe(gro, chain).timestep_ns(),
                 ValueError, "dt_ns")
    a, b = tu.Universe(gro, chain, dt_ns=0.1), ju.Universe(gro, chain,
                                                           dt_ns=0.1)
    _assert_batches(list(a.iter_batches(4)), list(b.iter_batches(4)))
    _same(a.frame_positions([4, 1]), b.frame_positions([4, 1]))
    # two segments whose clocks restart
    tn.XTCWriter(str(tmp_path / "c.xtc")).write(coords[:1], [5.0], box[:1])
    tn.XTCWriter(str(tmp_path / "d.xtc")).write(coords[1:4],
                                                np.arange(3) * 0.1, box[1:4])
    restarted = [str(tmp_path / "c.xtc"), str(tmp_path / "d.xtc")]
    _raise_alike(lambda p: PKGS[p][3].Universe(gro, restarted).timestep_ns(),
                 ValueError, "non-increasing")


@pytest.mark.parametrize("name", ["CA", "HG1", "CL", "NA", "OW", "1HB", "XX",
                                  "C1", "FE", "MG", "ZN", "S", "P", "K"])
def test_guess_mass_equal(name):
    assert ttop.guess_mass(name) == jtop.guess_mass(name)


# ------------------------------ contacts ----------------------------------- #

def _visit_frames(F=8):
    """Nine atoms: the protein at 10 A, CHOL copy 1 visits it in frames
    2-4 (the fixture of ``test_prmtop_ncdf_contacts`` / ``test_psf_trr``)."""
    pos = np.zeros((F, 9, 3), np.float32)
    pos[:, 0:3] = [10.0, 10.0, 10.0]
    pos[:, 3:5] = [40.0, 40.0, 40.0]
    pos[:, 5:7] = [70.0, 70.0, 70.0]
    pos[:, 7:9] = [80.0, 80.0, 80.0]
    for f in range(2, 5):
        pos[f, 5:7] = [12.0, 10.0, 10.0]
    return pos


def _contacts_both(top, traj):
    """Records and events of ``MapContacts`` in both packages (the port on
    the CPU) from one topology + trajectory pair."""
    out = []
    for U, mod, cfg, meta, kw in (
            (tu.Universe, tm, ContactConfig(map_cutoff=10.0), ContactMeta,
             {"device": "cpu"}),
            (ju.Universe, jm, JConfig(map_cutoff=10.0), JMeta, {})):
        u = U(top, traj)
        i1, i2 = u.select_atoms("protein"), u.select_atoms("resname CHOL")
        mc = mod.MapContacts(indices1=i1, resids1=u.topology.resids[i1],
                             indices2=i2, resids2=u.topology.resids[i2],
                             cfg=cfg, meta=meta(ts=u.timestep_ns()), **kw)
        rec = mc.run(u.iter_batches(batch_size=4))
        out.append((rec, mod.ProcessContacts(cutoff=7.0).run(rec)))
    (ra, ea), (rb, eb) = out
    assert len(ra) == len(rb) > 0
    for f in ("frames", "sel1_resids", "sel2_resids", "times"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    np.testing.assert_allclose(ra.min_dist, rb.min_dist, atol=1e-4, rtol=0)
    for f in ("sel1_resids", "sel2_resids", "start_times", "durations"):
        np.testing.assert_array_equal(getattr(ea, f), getattr(eb, f))
    return {(int(a), int(b)): (s, d) for a, b, s, d in zip(
        ea.sel1_resids, ea.sel2_resids, ea.start_times, ea.durations)}


def test_prmtop_ncdf_contacts_equal(tmp_path):
    p = tmp_path / "t.prmtop"
    p.write_text(jt.PRMTOP_TEXT)
    F = 8
    traj = str(tmp_path / "t.nc")
    with tn.trajectory_writer(traj) as w:
        w.write(_visit_frames(F), np.arange(F) * 0.1,
                np.tile([90.0] * 3, (F, 1)))
    rows = _contacts_both(str(p), traj)
    assert rows[(1, 3)] == pytest.approx((0.2, 0.3), abs=1e-6)


def test_psf_trr_contacts_equal(tmp_path):
    p = tmp_path / "t.psf"
    p.write_text(jt.TestPSF.PSF_TEXT)
    F = 8
    traj = str(tmp_path / "t.trr")
    tn.TRRWriter(traj).write(_visit_frames(F), np.arange(F) * 0.1,
                             np.tile([90.0] * 3, (F, 1)))
    rows = _contacts_both(str(p), traj)
    assert rows[(10, 100)] == pytest.approx((0.2, 0.3), abs=1e-6)
