"""The port's file layer (``basicrta_torch.io`` and its native codec)
against the JAX package's (``basicrta_tpu.io``): host code copied with its
imports re-pointed, so everything here is exact. Trajectory files written
by either codec read back bitwise through the other; every topology
format parses to equal fields; selection strings give equal atom indices;
``Universe.iter_batches`` yields equal batches. The sample files are those
of ``tests/test_io.py``."""

import dataclasses
import os

import numpy as np
import pytest

import test_io as jt   # the JAX package's I/O tests: sample files

from basicrta_tpu.io import native as jn
from basicrta_tpu.io import topology as jtop
from basicrta_tpu.io import universe as ju
from basicrta_tpu.io.amber import read_prmtop as j_read_prmtop
from basicrta_tpu.io.gmxdump import read_tpr_dump as j_read_dump

from basicrta_torch.io import native as tn
from basicrta_torch.io import topology as ttop
from basicrta_torch.io import universe as tu
from basicrta_torch.io.amber import read_prmtop
from basicrta_torch.io.gmxdump import read_tpr_dump

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["mdio.cpp", "xdrf.cpp", "xdrf.h"])
def test_codec_sources_equal_the_jax_package(name):
    """The copies cannot drift: byte for byte the reference's sources."""
    with open(os.path.join(REPO, "basicrta_tpu", "native", name), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "basicrta_torch", "native", name),
              "rb") as f:
        assert f.read() == want


def test_codec_builds_into_the_ports_own_directory():
    lib = tn.build_library()
    assert os.path.dirname(lib) == os.path.join(REPO, "basicrta_torch",
                                                "build")
    assert tn.build_library() == lib          # keyed by the sources' hash
    tn.XTCWriter                              # bound lazily
    assert "basicrta_tpu" not in tn._load()._name


def _frames(rng, F=7, A=60, triclinic=False):
    coords = rng.uniform(-20, 80, (F, A, 3)).astype(np.float32)
    times = np.arange(F) * 0.1
    if triclinic:
        H = np.array([[50.0, 0, 0], [10.0, 48.0, 0], [-5.0, 7.0, 45.0]],
                     np.float32)
        return coords, times, np.tile(H, (F, 1, 1))
    return coords, times, np.tile([50.0, 55.0, 60.0], (F, 1))


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("fmt", ["xtc", "trr"])
def test_xdr_trajectories_cross_read_bitwise(rng, tmp_path, fmt, triclinic):
    coords, times, box = _frames(rng, triclinic=triclinic)
    W = {"xtc": "XTCWriter", "trr": "TRRWriter"}[fmt]
    R = {"xtc": "XTCReader", "trr": "TRRReader"}[fmt]
    pt, pj = str(tmp_path / f"t.{fmt}"), str(tmp_path / f"j.{fmt}")
    wt, wj = getattr(tn, W)(pt), getattr(jn, W)(pj)
    for w in (wt, wj):                        # two chunks: the append path
        w.write(coords[:4], times[:4], box[:4])
        w.write(coords[4:], times[4:], box[4:],
                steps=np.arange(4, 7, dtype=np.int32))
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()           # the files themselves
    own = getattr(tn, R)(pt).read()
    _assert_same(own, getattr(jn, R)(pt).read())
    _assert_same(own, getattr(tn, R)(pj).read())
    _assert_same(getattr(tn, R)(pt).read([5, 0, 3]),
                 getattr(jn, R)(pj).read([5, 0, 3]))
    tol = 0.006 if fmt == "xtc" else 1e-5     # XTC keeps a 0.01 A grid
    np.testing.assert_allclose(own[0], coords, atol=tol)
    np.testing.assert_allclose(own[1], times, atol=1e-6)


def test_dcd_cross_read_bitwise(rng, tmp_path):
    coords, times, box = _frames(rng)
    pt, pj = str(tmp_path / "t.dcd"), str(tmp_path / "j.dcd")
    tn.DCDWriter(pt, delta=2.0, nsavc=5).write(coords, box)
    jn.DCDWriter(pj, delta=2.0, nsavc=5).write(coords, box)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    rt, rj = tn.DCDReader(pt), jn.DCDReader(pt)
    assert (rt.natoms, rt.nframes, rt.delta, rt.nsavc, rt.charmm) == (
        rj.natoms, rj.nframes, rj.delta, rj.nsavc, rj.charmm)
    _assert_same(rt.read(), rj.read())
    _assert_same(tn.DCDReader(pj).read([6, 2]), rj.read([6, 2]))
    np.testing.assert_array_equal(rt.read()[0], coords)


@pytest.mark.parametrize("ext", ["xtc", "trr", "dcd", "nc"])
def test_trajectory_writer_facade(rng, tmp_path, ext):
    coords, times, box = _frames(rng)
    paths = []
    for mod, stem in ((tn, "t"), (jn, "j")):
        p = str(tmp_path / f"{stem}.{ext}")
        w = mod.trajectory_writer(p, dt_ns=0.1)
        w.write(coords[:3], times[:3], box[:3])
        w.write(coords[3:], times[3:], box[3:])
        w.close()
        paths.append(p)
    top = ttop.Topology(np.full(60, "C"), np.arange(60, dtype=np.int32),
                        np.full(60, "LIG"))
    g = str(tmp_path / "t.gro")
    ttop.write_gro(g, top, coords[0], box[0])
    a = list(tu.Universe(g, paths[0], dt_ns=0.1).iter_batches(4))
    b = list(ju.Universe(g, paths[1], dt_ns=0.1).iter_batches(4))
    _assert_batches(a, b)
    with pytest.raises(ValueError, match="no trajectory writer"):
        tn.trajectory_writer(str(tmp_path / "x.xyz"))


def _assert_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for f in ("frame_ids", "times", "positions", "box"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None)
            if u is not None:
                np.testing.assert_array_equal(u, v)
                assert u.dtype == v.dtype


def _assert_topologies(a, b):
    for f in dataclasses.fields(jtop.Topology):
        u, v = getattr(a, f.name), getattr(b, f.name)
        assert (u is None) == (v is None), f.name
        if u is not None:
            np.testing.assert_array_equal(u, v)
            assert np.asarray(u).dtype == np.asarray(v).dtype, f.name


def _topology_files(tmp_path):
    """{format: path} of one nine-atom system in every topology format."""
    top = jt._make_topology()
    out = {}
    out["gro"] = jtop.write_gro(str(tmp_path / "s.gro"), top)
    out["pdb"] = jtop.write_pdb(str(tmp_path / "s.pdb"), top)
    (tmp_path / "s.psf").write_text(jt.TestPSF.PSF_TEXT)
    (tmp_path / "s.prmtop").write_text(jt.PRMTOP_TEXT)
    (tmp_path / "s.tpr.dump").write_text(jt.TestGmxDump.DUMP)
    out.update(psf=str(tmp_path / "s.psf"), prmtop=str(tmp_path / "s.prmtop"),
               dump=str(tmp_path / "s.tpr.dump"))
    return out


_READERS = {"gro": (ttop.read_gro, jtop.read_gro),
            "pdb": (ttop.read_pdb, jtop.read_pdb),
            "psf": (ttop.read_psf, jtop.read_psf),
            "prmtop": (read_prmtop, j_read_prmtop),
            "dump": (read_tpr_dump, j_read_dump)}


@pytest.mark.parametrize("fmt", sorted(_READERS))
def test_topologies_parse_to_equal_fields(tmp_path, fmt):
    path = _topology_files(tmp_path)[fmt]
    mine, theirs = (read(path) for read in _READERS[fmt])
    assert mine.natoms == theirs.natoms > 0
    _assert_topologies(mine, theirs)
    _assert_topologies(tu.read_topology(path), ju.read_topology(path))


def test_topology_writers_write_equal_files(tmp_path):
    top = jt._make_topology()
    mine = ttop.Topology(**{f.name: getattr(top, f.name)
                            for f in dataclasses.fields(top)})
    for ext, wt, wj, kw in (
            ("gro", ttop.write_gro, jtop.write_gro, {"title": "t"}),
            ("pdb", ttop.write_pdb, jtop.write_pdb,
             {"tempfactors": {10: 2.5}, "occupancies": {101: 0.5}})):
        a = wt(str(tmp_path / f"a.{ext}"), mine, **kw)
        b = wj(str(tmp_path / f"b.{ext}"), top, **kw)
        assert open(a).read() == open(b).read()
    assert ttop.convert_aa_code("TRP") == jtop.convert_aa_code("TRP") == "W"
    with pytest.raises(ValueError, match="unknown residue"):
        ttop.convert_aa_code("CHOL")
    np.testing.assert_array_equal(
        ttop.box_from_cosines(*np.array([[30.0], [40.0], [50.0], [0.1],
                                         [0.2], [0.5]])),
        jtop.box_from_cosines(*np.array([[30.0], [40.0], [50.0], [0.1],
                                         [0.2], [0.5]])))


# selection strings of tests/test_io.py, valid and malformed
SELECTIONS = [
    "all", "protein", "not protein", "protein and name CA", "name CA",
    "name C* or name N", "name HB?", "name 'HB[0-9]'", 'name "C." or name N',
    'name "C.*" and resname CHOL', 'name "C[AB]"', 'name "c[ab]"',
    'resname "CHO."', "resname CHOL", "resname CH*", "resid 10",
    "resid 10-11", "resid 10 or resid 101", "resnum 1-2", "index 0 2",
    "index 3-5", "not index 0-8", "bynum 1 6 9", "bynum 2-4 8", "water",
    "nucleic", "not water and not nucleic", "segid PROA", "segid MEM*",
    "segid MEMB and name C1", "type CTL?", "type CT*", "type CTL2",
    "byres name CA", "byres around 200.0 resid 10", "around 5.0 name C",
    "around 8.5 name C", "same residue as name CA",
    "same resname as index 5", "name same resname as index 5",
    "same name as index 0", "same mass as index 0", "same charge as index 0",
    "same resname as resid 999", "prop mass > 13", "prop mass <= 1.1",
    "prop charge < 0", "prop abs charge >= 0.47", "prop x > 0",
    "prop abs x <= 6", "prop z >= 23", "resname CHOL prop mass > 12",
    "protein and prop mass > 1.1", "point 0 0 0 5", "point 8.0 0 0 4.5",
    "name CA point 0 0 0 5", "sphzone 4.5 (name N or name C1)",
    "sphlayer 2 8.5 (name N or name C1)", "cyzone 7 12 -1 name CA",
    "cylayer 2 7 8 -8 name CA",
    # malformed: both must raise the same error
    "( protein", "bogus", "name", "around x name CA", "prop bogus > 1",
    "prop mass > heavy", "point 1 2 3 huge", "sphzone big name CA",
    "cyzone 3 tall -1 name CA", "cylayer 1 name CA", "same resname index 0",
    "same fragment as index 0", 'name "C[*"',
]


def _select(top, expr):
    try:
        return top.select(expr)
    except Exception as e:  # noqa: BLE001 - the error is the result
        return type(e), str(e)


@pytest.mark.parametrize("fmt", ["gro", "psf"])
def test_selection_strings_give_equal_indices(tmp_path, fmt):
    path = _topology_files(tmp_path)[fmt]
    mine, theirs = (read(path) for read in _READERS[fmt])
    if fmt == "psf":                    # PSF carries no coordinates
        mine.positions = theirs.positions = jt._make_topology().positions
    hits = 0
    for expr in SELECTIONS:
        a, b = _select(mine, expr), _select(theirs, expr)
        if isinstance(b, tuple):
            assert a == b, expr
        else:
            np.testing.assert_array_equal(a, b, err_msg=expr)
            assert a.dtype == b.dtype
            hits += len(a) > 0
    assert hits > 30
    idx = mine.select("protein")
    assert mine.residue_labels(idx) == theirs.residue_labels(idx)


def _two_segments(tmp_path, rng):
    top = jt._make_topology()
    gro = jtop.write_gro(str(tmp_path / "s.gro"), top)
    F = 11
    coords = (top.positions[None]
              + rng.normal(0, 1.0, (F, 9, 3))).astype(np.float32)
    box = np.tile([90.0, 90.0, 90.0], (F, 1))
    times = np.arange(F) * 0.1
    a, b = str(tmp_path / "a.xtc"), str(tmp_path / "b.xtc")
    tn.XTCWriter(a).write(coords[:6], times[:6], box[:6])
    tn.XTCWriter(b).write(coords[6:], times[6:], box[6:])
    return gro, a, b


def test_universe_batches_equal_single_file(tmp_path, rng):
    gro, a, _ = _two_segments(tmp_path, rng)
    mine, theirs = tu.Universe(gro, a), ju.Universe(gro, a)
    assert mine.n_frames == theirs.n_frames == 6
    assert mine.timestep_ns() == theirs.timestep_ns()
    _assert_batches(list(mine.iter_batches(4)), list(theirs.iter_batches(4)))
    _assert_batches(list(mine.iter_batches(2, frames=[5, 1, 2])),
                    list(theirs.iter_batches(2, frames=[5, 1, 2])))
    np.testing.assert_array_equal(mine.select_atoms("resname CHOL"),
                                  theirs.select_atoms("resname CHOL"))
    np.testing.assert_array_equal(mine.frame_positions([3]),
                                  theirs.frame_positions([3]))
    # no trajectory: the topology's own frame
    _assert_batches(list(tu.Universe(gro).iter_batches(1)),
                    list(ju.Universe(gro).iter_batches(1)))


def test_universe_batches_equal_two_segment_chain(tmp_path, rng):
    gro, a, b = _two_segments(tmp_path, rng)
    mine, theirs = tu.Universe(gro, [a, b]), ju.Universe(gro, [a, b])
    assert mine.n_frames == theirs.n_frames == 11
    _assert_batches(list(mine.iter_batches(4)), list(theirs.iter_batches(4)))
    # a batch that straddles the segments
    got = list(mine.iter_batches(4))[1]
    np.testing.assert_array_equal(got.frame_ids, [4, 5, 6, 7])
    with pytest.raises(ValueError, match="atom count"):
        bad = str(tmp_path / "bad.xtc")
        tn.XTCWriter(bad).write(np.zeros((2, 5, 3), np.float32),
                                np.arange(2) * 0.1, np.tile([9.0] * 3, (2, 1)))
        tu.Universe(gro, [a, bad])


def test_universe_errors_equal(tmp_path, rng):
    gro, a, _ = _two_segments(tmp_path, rng)
    for mod in (tu, ju):
        with pytest.raises(ValueError, match="unsupported topology"):
            mod.read_topology(str(tmp_path / "x.xyz"))
        with pytest.raises(ValueError, match="unsupported trajectory"):
            mod.Universe(gro, str(tmp_path / "x.xyz"))
        with pytest.raises(FileNotFoundError):
            mod.Universe(gro, str(tmp_path / "missing.xtc"))
    diag = np.tile(np.diag([30.0, 40.0, 50.0]), (2, 1, 1)).astype(np.float32)
    np.testing.assert_array_equal(tu._box_from_matrix(diag),
                                  ju._box_from_matrix(diag))
    diag[:, 1, 0] = 15.0
    assert tu._box_from_matrix(diag).shape == (2, 3, 3)
    cell = np.array([[30.0, 0.5, 40.0, 0.0, 0.0, 50.0]])
    with pytest.warns(UserWarning, match="cosines"):
        H = tu._box_from_unitcell(cell)
    with pytest.warns(UserWarning, match="cosines"):
        np.testing.assert_array_equal(H, ju._box_from_unitcell(cell))


def test_membrane_workloads_equal_bench(tmp_path):
    """The port's copies of bench.py's contact workloads give its frames,
    and the files written from them read back as the same system."""
    import bench
    from basicrta_torch.scripts import workload as wl
    for mine, theirs in ((wl.make_membrane_frames, bench.make_membrane_frames),
                         (wl.make_membrane_frames_large,
                          bench.make_membrane_frames_large)):
        a, ra1, ra2, A1 = mine(n_frames=3, batch=2)
        b, rb1, rb2, B1 = theirs(n_frames=3, batch=2)
        assert A1 == B1
        np.testing.assert_array_equal(ra1, rb1)
        np.testing.assert_array_equal(ra2, rb2)
        _assert_batches(a, b)
    gro, xtc = wl.write_membrane_files(str(tmp_path), a, ra1, ra2, "bilayer")
    u = tu.Universe(gro, xtc)
    idx1, idx2 = u.select_atoms("protein"), u.select_atoms("resname CHOL")
    np.testing.assert_array_equal(idx1, np.arange(A1))
    np.testing.assert_array_equal(idx2, np.arange(A1, A1 + len(ra2)))
    np.testing.assert_array_equal(u.topology.resids[idx1], ra1 + 1)
    np.testing.assert_array_equal(u.topology.resids[idx2], ra2)
    back = list(u.iter_batches(2))
    assert [len(x.frame_ids) for x in back] == [2, 1]
    np.testing.assert_allclose(back[0].positions, a[0].positions, atol=0.006)
    np.testing.assert_allclose(back[0].times, a[0].times, atol=1e-6)
    np.testing.assert_allclose(back[0].box, a[0].box, atol=1e-4)
