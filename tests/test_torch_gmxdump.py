"""The raw-``.tpr`` path of the port (``basicrta_torch.io.universe`` and
``io/gmxdump.py``) against the JAX package's, on the cases of
``tests/test_io.py::TestGmxDump``: the dump parses to equal fields, the
extension dispatch and the selections agree, both name the manual recipe
without ``gmx``, both render through a stub ``gmx`` and cache the text,
both report a failing ``gmx``'s stderr, and ``contacts`` from a raw
``.tpr`` gives equal rows and events in both CLIs. Everything here is
exact: host code on the same files.

The port keys its cache on the ``.tpr``'s SHA-256 (``{path}.dump.sha256``)
where the reference compares mtimes, and turns an unwritable cache into
the recipe ``ValueError``: the last two tests hold that divergence."""

import builtins
import os

import numpy as np
import pytest

import test_io as jt   # the JAX package's I/O tests: the dump fixture

from basicrta_tpu import cli as jcli
from basicrta_tpu.config import ContactConfig as JConfig
from basicrta_tpu.contacts import mapper as jm
from basicrta_tpu.contacts.records import ContactEvents as JEvents
from basicrta_tpu.contacts.records import ContactMeta as JMeta
from basicrta_tpu.contacts.records import ContactRecords as JRecords
from basicrta_tpu.io import gmxdump as jg
from basicrta_tpu.io import universe as ju

from basicrta_torch import cli
from basicrta_torch.config import ContactConfig
from basicrta_torch.contacts import mapper as tm
from basicrta_torch.contacts.records import ContactEvents, ContactMeta
from basicrta_torch.contacts.records import ContactRecords
from basicrta_torch.io import gmxdump as tg
from basicrta_torch.io import universe as tu
from basicrta_torch.io.native import XTCWriter

from test_torch_io import _assert_batches, _assert_topologies

DUMP = jt.TestGmxDump.DUMP
PACKAGES = {"torch": tu, "jax": ju}


# the JAX test's fake ``gmx`` on PATH: it prints ``tmp_path/payload.dump``
# for ``gmx dump -s`` and counts its calls in ``tmp_path/gmx_calls``
_stub_gmx = jt.TestGmxDump()._stub_gmx


def _calls(count):
    return count.read_text().count("x") if count.exists() else 0


def _tpr(dirpath, data=b"\x00\x01binary"):
    p = dirpath / "topol.tpr"
    p.write_bytes(data)
    return p


def test_dump_parses_to_equal_fields(tmp_path):
    p = tmp_path / "demo.tpr.dump"
    p.write_text(DUMP)
    mine, theirs = tg.read_tpr_dump(str(p)), jg.read_tpr_dump(str(p))
    assert mine.natoms == 18
    _assert_topologies(mine, theirs)
    assert list(mine.resids[:6]) == [313, 313, 314, 314, 315, 315]
    assert list(mine.resids[6::4]) == [316, 317, 318]
    assert tg.looks_like_tpr_dump(str(p)) == jg.looks_like_tpr_dump(str(p))


@pytest.mark.parametrize("name", ["demo.tpr.dump", "copied.txt"])
def test_dispatch_and_selections_equal(tmp_path, name):
    p = tmp_path / name
    p.write_text(DUMP)
    mine, theirs = tu.read_topology(str(p)), ju.read_topology(str(p))
    _assert_topologies(mine, theirs)
    for sel in ("protein", "resname CHOL", "resid 313-314",
                'name "C.*" and resname CHOL', "prop charge < -0.2",
                "type CTL2"):
        a, b = mine.select(sel), theirs.select(sel)
        np.testing.assert_array_equal(a, b, err_msg=sel)
        assert len(a) > 0
    idx = mine.select("protein")
    assert mine.residue_labels(idx) == theirs.residue_labels(idx) == \
        ["W313", "L314", "A315"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_no_gmx_names_the_recipe(tmp_path, monkeypatch, pkg):
    monkeypatch.setenv("PATH", str(tmp_path / "emptybin"))
    monkeypatch.delenv("BASICRTA_GMX", raising=False)
    p = _tpr(tmp_path)
    with pytest.raises(ValueError, match="gmx dump -s") as e:
        PACKAGES[pkg].read_topology(str(p))
    assert "no `gmx` on PATH" in str(e.value)
    assert not (tmp_path / "topol.tpr.dump").exists()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_raw_tpr_auto_dump_and_cache(tmp_path, monkeypatch, pkg):
    """The JAX test's sequence in each package: one render, a cache hit,
    and a re-render once the ``.tpr`` changes (2 s newer)."""
    read = PACKAGES[pkg].read_topology
    count = _stub_gmx(tmp_path, monkeypatch)
    p = _tpr(tmp_path)
    top = read(str(p))
    assert top.natoms == 18 and _calls(count) == 1
    cache = tmp_path / "topol.tpr.dump"
    assert cache.read_text() == DUMP          # exactly what gmx printed
    read(str(p))
    assert _calls(count) == 1                 # cache hit
    p.write_bytes(b"\x00\x02binary-v2")
    os.utime(p, (os.path.getmtime(p) + 2,) * 2)
    read(str(p))
    assert _calls(count) == 2
    _assert_topologies(top, jg.read_tpr_dump(str(cache)))


def test_ports_cache_reads_in_the_jax_package(tmp_path, monkeypatch):
    """The port's ``.dump`` is plain ``gmx dump`` text: the JAX package
    parses it, and its own ``read_topology`` of the raw ``.tpr`` serves
    it (the cache is newer) without calling ``gmx``."""
    count = _stub_gmx(tmp_path, monkeypatch)
    p = _tpr(tmp_path)
    mine = tu.read_topology(str(p))
    os.utime(tmp_path / "topol.tpr.dump",
             (os.path.getmtime(p) + 1,) * 2)
    _assert_topologies(mine, ju.read_topology(str(p)))
    assert _calls(count) == 1
    assert (tmp_path / "topol.tpr.dump.sha256").read_text().strip() == \
        tu._tpr_digest(str(p))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_gmx_failure_reports_stderr(tmp_path, monkeypatch, pkg):
    _stub_gmx(tmp_path, monkeypatch, fail=True)
    p = _tpr(tmp_path)
    with pytest.raises(ValueError, match="fatal error"):
        PACKAGES[pkg].read_topology(str(p))
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["bin", "gmx_calls", "payload.dump", "topol.tpr"])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_basicrta_gmx_overrides_path(tmp_path, monkeypatch, pkg):
    path = os.environ["PATH"]                 # no gmx on it
    count = _stub_gmx(tmp_path, monkeypatch)
    monkeypatch.setenv("PATH", path)
    monkeypatch.setenv("BASICRTA_GMX", str(tmp_path / "bin" / "gmx"))
    assert PACKAGES[pkg].read_topology(str(_tpr(tmp_path))).natoms == 18
    assert _calls(count) == 1


def _frames(F=6):
    """CHOL copy 1 (resid 316) within 7 A of TRP313's N in frames 1-3."""
    base = np.tile(np.arange(18, dtype=np.float32)[:, None] * 2.0, (1, 3))
    frames = []
    for k in range(F):
        c = base.copy()
        c[6:10] = c[0] + np.float32(2.0 if 1 <= k <= 3 else 20.0)
        frames.append(c)
    return np.stack(frames)


def _xtc(dirpath):
    xtc = str(dirpath / "t.xtc")
    XTCWriter(xtc).write(_frames(), np.arange(6) * 0.1,
                         [[50.0, 50.0, 40.0]] * 6)
    return xtc


def test_cli_contacts_from_raw_tpr(tmp_path, monkeypatch):
    """``contacts --top x.tpr`` in both CLIs (the port on the CPU): equal
    records and events, and (313, 316) from 0.1 ns for 0.3 ns."""
    count = _stub_gmx(tmp_path, monkeypatch)
    p = _tpr(tmp_path)
    xtc = _xtc(tmp_path)
    out = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        main(["contacts", "--top", str(p), "--traj", xtc, "--sel1",
              "protein", "--sel2", "resname CHOL", "--cutoff", "7.0",
              "--batch", "4", *extra])
        out[name] = d
    # the port rendered once; the JAX package served the port's newer cache
    assert _calls(count) == 1
    a = ContactRecords.load(str(out["torch"] / "contacts.npz"))
    b = JRecords.load(str(out["jax"] / "contacts.npz"))
    assert len(a) == len(b) > 0
    for f in ("frames", "sel1_resids", "sel2_resids", "times"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.min_dist, b.min_dist, atol=1e-4, rtol=0)
    ea = ContactEvents.load(str(out["torch"] / "contacts_7.0.npz"))
    eb = JEvents.load(str(out["jax"] / "contacts_7.0.npz"))
    for f in ("sel1_resids", "sel2_resids", "start_times", "durations"):
        np.testing.assert_array_equal(getattr(ea, f), getattr(eb, f))
    rows = {(int(x), int(y)): (s, d) for x, y, s, d in zip(
        ea.sel1_resids, ea.sel2_resids, ea.start_times, ea.durations)}
    assert rows[(313, 316)] == pytest.approx((0.1, 0.3), abs=1e-5)


def test_contacts_from_dump_topology(tmp_path):
    """``MapContacts`` from a dump topology + XTC in both packages: equal
    batches, records and events."""
    top = tmp_path / "demo.tpr.dump"
    top.write_text(DUMP)
    xtc = _xtc(tmp_path)
    um, uj = tu.Universe(str(top), xtc), ju.Universe(str(top), xtc)
    _assert_batches(list(um.iter_batches(4)), list(uj.iter_batches(4)))
    res = []
    for u, mod, cfg, meta, kw in (
            (um, tm, ContactConfig(), ContactMeta, {"device": "cpu"}),
            (uj, jm, JConfig(), JMeta, {})):
        s1, s2 = u.select_atoms("protein"), u.select_atoms("resname CHOL")
        mc = mod.MapContacts(indices1=s1, resids1=u.topology.resids[s1],
                             indices2=s2, resids2=u.topology.resids[s2],
                             cfg=cfg, meta=meta(ts=u.timestep_ns()), **kw)
        rec = mc.run(u.iter_batches(batch_size=4))
        res.append((rec, mod.ProcessContacts(cutoff=7.0).run(rec)))
    (ra, ea), (rb, eb) = res
    for f in ("frames", "sel1_resids", "sel2_resids", "times"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    for f in ("sel1_resids", "sel2_resids", "start_times", "durations"):
        np.testing.assert_array_equal(getattr(ea, f), getattr(eb, f))
    rows = {(int(x), int(y)): (s, d) for x, y, s, d in zip(
        ea.sel1_resids, ea.sel2_resids, ea.start_times, ea.durations)}
    assert rows[(313, 316)] == pytest.approx((0.1, 0.3), abs=1e-5)


def test_rewrite_within_one_tick_re_renders(tmp_path, monkeypatch):
    """A ``.tpr`` rewritten with the same size and given the cache's mtime
    is a new topology: the port renders it again (2 calls) and reads the
    new atoms. The reference's mtime test serves the stale dump (its
    stated fault, kept in ``basicrta_tpu``)."""
    count = _stub_gmx(tmp_path, monkeypatch)
    p = _tpr(tmp_path, b"\x00\x01binary-v1")
    assert tu.read_topology(str(p)).natoms == 18
    cache = tmp_path / "topol.tpr.dump"
    stamp = os.stat(cache).st_mtime_ns
    # the new topology: TRP313 renamed to PHE313
    new = DUMP.replace('name="TRP", nr=313', 'name="PHE", nr=313')
    (tmp_path / "payload.dump").write_text(new)
    p.write_bytes(b"\x00\x01binary-v2")        # same size
    os.utime(p, ns=(stamp, stamp))             # same mtime as the cache
    assert os.path.getmtime(cache) >= os.path.getmtime(p)
    stale = ju.read_topology(str(p))            # the reference: no call
    assert _calls(count) == 1 and stale.resnames[0] == "TRP"
    top = tu.read_topology(str(p))
    assert _calls(count) == 2
    assert top.resnames[0] == "PHE"
    assert top.residue_labels(top.select("protein")) == \
        ["F313", "L314", "A315"]
    assert cache.read_text() == new
    tu.read_topology(str(p))                    # and the new one is cached
    assert _calls(count) == 2


@pytest.mark.parametrize("target", [".dump.tmp", ".sha256.tmp"])
def test_unwritable_cache_gives_the_recipe(tmp_path, monkeypatch, target):
    """A cache that cannot be written (a read-only directory) raises the
    manual recipe as a ``ValueError`` naming the directory, and leaves no
    partial file and no sidecar behind."""
    count = _stub_gmx(tmp_path, monkeypatch)
    p = _tpr(tmp_path)
    real_open = builtins.open

    def guarded(file, *a, **kw):
        if str(file).endswith(target):
            raise PermissionError(13, "Permission denied", str(file))
        return real_open(file, *a, **kw)

    monkeypatch.setattr(builtins, "open", guarded)
    with pytest.raises(ValueError, match="gmx dump -s") as e:
        tu.read_topology(str(p))
    assert str(tmp_path) in str(e.value)
    assert isinstance(e.value.__cause__, PermissionError)
    assert _calls(count) == (target == ".sha256.tmp")
    left = set(os.listdir(tmp_path)) - {"bin", "gmx_calls", "payload.dump",
                                        "topol.tpr", "topol.tpr.dump"}
    assert left == set()
    assert not (tmp_path / "topol.tpr.dump.sha256").exists()
    monkeypatch.setattr(builtins, "open", real_open)
    assert tu.read_topology(str(p)).natoms == 18   # writable again: renders


def test_interrupted_render_leaves_no_stale_sidecar(tmp_path, monkeypatch):
    """v1 is cached; v2's render stops before its sidecar is written; the
    ``.tpr`` goes back to v1's bytes. The dump on disk is v2's, so v1 must
    be rendered again, not served from the old sidecar's digest."""
    count = _stub_gmx(tmp_path, monkeypatch)
    p = _tpr(tmp_path, b"\x00\x01binary-v1")
    assert tu.read_topology(str(p)).resnames[0] == "TRP"
    (tmp_path / "payload.dump").write_text(
        DUMP.replace('name="TRP", nr=313', 'name="PHE", nr=313'))
    p.write_bytes(b"\x00\x01binary-v2")
    real_open = builtins.open

    def guarded(file, *a, **kw):
        if str(file).endswith(".sha256.tmp"):
            raise PermissionError(13, "Permission denied", str(file))
        return real_open(file, *a, **kw)

    monkeypatch.setattr(builtins, "open", guarded)
    with pytest.raises(ValueError, match="gmx dump -s"):
        tu.read_topology(str(p))
    monkeypatch.setattr(builtins, "open", real_open)
    assert _calls(count) == 2
    (tmp_path / "payload.dump").write_text(DUMP)
    p.write_bytes(b"\x00\x01binary-v1")
    assert tu.read_topology(str(p)).resnames[0] == "TRP"
    assert _calls(count) == 3
