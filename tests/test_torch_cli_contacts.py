"""``basicrta-torch contacts`` against ``basicrta-tpu contacts`` on the same
files, and the chain file -> contacts -> events -> tau of the port.

Both CLIs scan one tmp ``.gro`` + ``.xtc`` (the port with ``--device cpu``)
and must write equal ``contacts.npz`` and ``contacts_7.0.npz``: identical
rows, frames, times and events; ``min_dist`` within 1e-4 A (both take the
u16 wire format for an XTC input and quantize bit for bit alike). Each
artifact loads in the other package. ``gibbs --engine torch`` on the result
names its directories from the topology; the default device raises
without a GPU."""

import os

import numpy as np
import pytest
import torch

from basicrta_tpu import cli as jcli
from basicrta_tpu.contacts.records import ContactEvents as JEvents
from basicrta_tpu.contacts.records import ContactRecords as JRecords

from basicrta_torch import cli
from basicrta_torch.config import ContactConfig
from basicrta_tpu.config import ContactConfig as JContactConfig
from basicrta_torch.contacts.records import ContactEvents, ContactRecords
from basicrta_torch.io.native import XTCWriter
from basicrta_torch.io.topology import Topology, write_gro
from basicrta_torch.protein.driver import residue_labels_for

SEL = ["--sel1", "protein", "--sel2", "resname CHOL"]
AA = ("TRP", "ALA", "GLY", "LYS")


def _system(dirpath, F=40, seed=5):
    """4 protein residues x 4 atoms and 6 two-atom CHOL that wander in and
    out of contact: runs of contact frames of several lengths."""
    rng = np.random.default_rng(seed)
    R1, P1, R2, P2 = 4, 4, 6, 2
    c1 = rng.uniform(5, 25, (R1, 3))
    walk = np.cumsum(rng.normal(0, 1.2, (F, R2, 3)), axis=0)
    c2 = rng.uniform(5, 25, (R2, 3))[None] + walk
    p1 = c1[None, :, None] + rng.normal(0, 0.8, (F, R1, P1, 3))
    p2 = c2[:, :, None] + rng.normal(0, 0.8, (F, R2, P2, 3))
    pos = np.concatenate([p1.reshape(F, -1, 3), p2.reshape(F, -1, 3)],
                         axis=1).astype(np.float32)
    resids = np.concatenate([np.repeat(np.arange(R1) + 313, P1),
                             np.repeat(np.arange(R2) + 900, P2)])
    resnames = np.concatenate([np.repeat(AA, P1), np.full(R2 * P2, "CHOL")])
    names = np.concatenate([np.tile(["N", "CA", "C", "O"], R1),
                            np.tile(["C1", "C2"], R2)])
    box = np.array([30.0, 30.0, 30.0], np.float32)
    top = Topology(names, resids.astype(np.int32), resnames, pos[0], box)
    gro = write_gro(os.path.join(dirpath, "s.gro"), top)
    xtc = os.path.join(dirpath, "s.xtc")
    XTCWriter(xtc).write(pos, np.arange(F) * 0.1, np.tile(box, (F, 1)))
    return gro, xtc


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """{'torch' | 'jax': directory} after each package's contacts CLI."""
    base = tmp_path_factory.mktemp("cli_contacts")
    gro, xtc = _system(str(base))
    out = {}
    cwd = os.getcwd()
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        d = base / name
        d.mkdir()
        os.chdir(d)
        try:
            main(["contacts", "--top", gro, "--traj", xtc, *SEL, "--cutoff",
                  "7.0", "5.5", "--batch", "16", "--checkpoint-every", "16",
                  *extra])
        finally:
            os.chdir(cwd)
        out[name] = str(d)
    return out


def test_contacts_npz_equal(scans):
    a = ContactRecords.load(os.path.join(scans["torch"], "contacts.npz"))
    b = JRecords.load(os.path.join(scans["jax"], "contacts.npz"))
    assert len(a) == len(b) > 50
    for f in ("frames", "sel1_resids", "sel2_resids", "times"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    np.testing.assert_allclose(a.min_dist, b.min_dist, atol=1e-4, rtol=0)
    assert a.meta.to_dict() == b.meta.to_dict()
    assert a.meta.ts == pytest.approx(0.1, rel=1e-5)
    assert a.meta.sel2 == "resname CHOL" and a.meta.cutoff == 10.0


@pytest.mark.parametrize("cutoff", ["7.0", "5.5"])
def test_event_tables_equal_and_cross_load(scans, cutoff):
    name = f"contacts_{cutoff}.npz"
    mine = os.path.join(scans["torch"], name)
    theirs = os.path.join(scans["jax"], name)
    # each artifact through each package's loader
    tables = [ContactEvents.load(mine), ContactEvents.load(theirs),
              JEvents.load(mine), JEvents.load(theirs)]
    a = tables[0]
    assert len(a) > 5 and len(np.unique(a.durations)) > 2
    for b in tables[1:]:
        for f in ("sel1_resids", "sel2_resids", "start_times", "durations"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.meta.to_dict() == b.meta.to_dict()
    assert a.meta.cutoff == float(cutoff)


def test_records_cross_load_both_ways(scans):
    for d in scans.values():
        p = os.path.join(d, "contacts.npz")
        a, b = ContactRecords.load(p), JRecords.load(p)
        for f in ("frames", "sel1_resids", "sel2_resids", "min_dist",
                  "times"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.meta.to_dict() == b.meta.to_dict()
    assert not os.path.exists(os.path.join(scans["torch"],
                                           "contacts.npz.ckpt"))


@pytest.mark.parametrize("kw", [{}, dict(map_cutoff=8.0, upload_dtype="u16",
                                         prefilter=True, transfer_cap=64)])
def test_contact_config_json_equals_jax(kw):
    a, b = ContactConfig(**kw), JContactConfig(**kw)
    assert a.to_json() == b.to_json()
    assert ContactConfig.from_json(b.to_json()) == a
    assert JContactConfig.from_json(a.to_json()) == b


def test_gibbs_names_directories_from_the_topology(scans, tmp_path,
                                                   monkeypatch):
    events = ContactEvents.load(os.path.join(scans["torch"],
                                             "contacts_7.0.npz"))
    resids = np.unique(events.sel1_resids)
    labels = residue_labels_for(events, resids)
    assert labels == [f"{'WAGK'[r - 313]}{r}" for r in resids]
    monkeypatch.chdir(tmp_path)
    cli.main(["gibbs", "--contacts",
              os.path.join(scans["torch"], "contacts_7.0.npz"), "--engine",
              "torch", "--niter", "300", "--g", "10", "--ncomp", "3",
              "--nchains", "1"])
    made = sorted(d for d in os.listdir(tmp_path / "basicrta-7.0")
                  if not d.startswith("."))
    assert made and set(made) <= set(labels)
    assert not any(d.startswith("X") for d in made)
    cli.main(["cluster", "--cutoff", "7.0", "--niter", "300", "--engine",
              "torch"])
    taus = np.load(tmp_path / "tausout.npy")
    assert taus.shape == (len(made), 4) and np.isfinite(taus).all()
    assert sorted(taus[:, 0].astype(int)) == sorted(int(d[1:]) for d in made)


def test_labels_fall_back_loudly(scans, tmp_path):
    events = ContactEvents.load(os.path.join(scans["torch"],
                                             "contacts_7.0.npz"))
    bad = tmp_path / "broken.gro"
    bad.write_text("not a gro file\n")
    events.meta.top = str(bad)
    with pytest.warns(UserWarning, match="X-prefixed"):
        assert residue_labels_for(events, np.array([313])) == ["X313"]
    events.meta.top = str(tmp_path / "missing.gro")
    assert residue_labels_for(events, np.array([313, 5])) == ["X313", "X5"]
    events.meta.top = None
    assert residue_labels_for(events, np.array([7])) == ["X7"]


def test_contacts_default_device_raises_without_a_gpu(scans, tmp_path,
                                                      monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gro, xtc = _system(str(tmp_path), F=4)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["contacts", "--top", gro, "--traj", xtc, *SEL])
    assert not os.path.exists(tmp_path / "contacts.npz")
    # frame shards over the cards need cards too
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["contacts", "--top", gro, "--traj", xtc, *SEL,
                  "--ndevices", "2"])
    assert not os.path.exists(tmp_path / "contacts.npz")


def test_contacts_cutoff_above_the_map_cutoff_is_refused(tmp_path,
                                                         monkeypatch):
    gro, xtc = _system(str(tmp_path), F=4)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="exceed the map cutoff"):
        cli.main(["contacts", "--top", gro, "--traj", xtc, *SEL, "--cutoff",
                  "12.0", "--device", "cpu"])


def test_contacts_module_entry_point(tmp_path, monkeypatch):
    """``python -m basicrta_torch.contacts`` is the contacts subcommand."""
    import runpy
    import sys
    gro, xtc = _system(str(tmp_path), F=6)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["contacts", "--top", gro, "--traj",
                                      xtc, *SEL, "--device", "cpu",
                                      "--upload", "f32"])
    runpy.run_module("basicrta_torch.contacts", run_name="__main__")
    assert len(ContactRecords.load(str(tmp_path / "contacts.npz"))) > 0
    assert os.path.exists(tmp_path / "contacts_7.0.npz")
