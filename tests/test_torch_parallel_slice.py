"""The multi-device slice of basicrta_torch as a whole, on the CPU against
the JAX package's multi-device runs (8 virtual CPU devices,
``tests/conftest.py``): ``ParallelGibbs.run(n_devices=2)`` against JAX's on
its fused engine, frame-sharded ``MapContacts`` rows and
``GridAccumulator(mesh=)`` densities against both the unsharded run and
JAX's sharded one, ``parallel.distributed`` in one process and in two gloo
processes on localhost, and the CLI's ``--ndevices`` / ``--multihost``."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from basicrta_tpu.config import ContactConfig as JContactConfig
from basicrta_tpu.config import GibbsConfig as JConfig
from basicrta_tpu.contacts import mapper as jm
from basicrta_tpu.contacts.records import ContactEvents as JEvents
from basicrta_tpu.contacts.records import ContactMeta as JMeta
from basicrta_tpu.kinetics.density import GridAccumulator as JGrid
from basicrta_tpu.parallel.mesh import make_mesh as jmake_mesh
from basicrta_tpu.protein.driver import ParallelGibbs as JParallelGibbs
from basicrta_torch import cli
from basicrta_torch.config import ContactConfig, GibbsConfig
from basicrta_torch.contacts import mapper as tm
from basicrta_torch.contacts.records import (ContactEvents, ContactMeta,
                                             ContactRecords, FrameBatch)
from basicrta_torch.kinetics.density import GridAccumulator
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.parallel import distributed
from basicrta_torch.parallel.mesh import make_mesh
from basicrta_torch.protein.driver import ParallelGibbs
from basicrta_torch.sampler.gibbs import Gibbs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Chains are many small eager steps: with torch's intra-op threads,
    each step waits for threads that the suite's other workers keep busy.
    One thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _times(n, seed, w=(0.85, 0.15), r=(2.0, 0.1)):
    return discretize_times(simulate_hyperexp(
        n, list(w), list(r), np.random.default_rng(seed)), 0.1)


def _table(sizes):
    resids = np.concatenate([np.full(n, r, np.int32)
                             for r, n in sizes.items()])
    dur = np.concatenate([_times(n, r) for r, n in sizes.items()])
    zeros = np.zeros_like(resids)
    return resids, zeros, np.zeros_like(dur), dur


def test_parallel_gibbs_on_two_devices_against_jax(tmp_path):
    """Three residues x 2 chains, lanes over two devices in both packages
    (the port's plain engine on the pow2 ladder, JAX's fused engine in
    interpret mode on its production layout): every tau finite with
    0 <= lo <= hi, and the two packages' CIs overlap."""
    cols = _table({10: 250, 20: 150, 30: 100})
    kw = dict(ncomp=4, niter=200, g=10, burnin=50, n_chains=2)
    got = ParallelGibbs(ContactEvents(*cols, ContactMeta(cutoff=7.0)),
                        GibbsConfig(**kw), root=str(tmp_path / "t")).run(
        n_devices=2, device="cpu")
    want = JParallelGibbs(JEvents(*cols, JMeta(cutoff=7.0)), JConfig(**kw),
                          root=str(tmp_path / "j")).run(n_devices=2,
                                                        engine="pallas")
    assert sorted(got) == sorted(want) == ["X10", "X20", "X30"]
    for lab in got:
        lo, tau, hi = got[lab].tau
        jlo, _, jhi = want[lab].tau
        assert np.isfinite([lo, tau, hi]).all() and 0 <= lo <= hi
        assert lo <= jhi and jlo <= hi, (lab, got[lab].tau, want[lab].tau)
        assert got[lab].mcweights.shape == (2, 20, 4)
        path = tmp_path / "t" / "basicrta-7.0" / lab / "gibbs_200.npz"
        assert Gibbs.load(str(path)).tau == got[lab].tau


def test_all_visible_devices_of_the_cpu_is_the_unsharded_run(tmp_path):
    cols = _table({10: 200, 20: 120})
    cfg = GibbsConfig(ncomp=3, niter=40, g=10, burnin=10, n_chains=2,
                      gmm_n_init=4)
    ev = ContactEvents(*cols, ContactMeta(cutoff=7.0))
    a = ParallelGibbs(ev, cfg, root=str(tmp_path / "a")).run(device="cpu")
    b = ParallelGibbs(ev, cfg, root=str(tmp_path / "b")).run(device="cpu",
                                                            n_devices=0)
    for lab in a:
        np.testing.assert_array_equal(a[lab].mcweights, b[lab].mcweights)
        assert a[lab].tau == b[lab].tau


def test_n_devices_beyond_the_visible_cards_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ev = ContactEvents(*_table({10: 100}), ContactMeta(cutoff=7.0))
    with pytest.raises(ValueError, match="3 devices asked for, 1 cards"):
        ParallelGibbs(ev, GibbsConfig(niter=20, g=10),
                      root=str(tmp_path)).run(engine="cuda", n_devices=3)
    with pytest.raises(ValueError, match="2 devices asked for, 1 cards"):
        tm.MapContacts(np.arange(4), np.arange(4), np.arange(4, 8),
                       np.arange(4), n_devices=2)


# ---------------------------------------------------------------- frames

def _system(rng, F, R1=8, P1=5, R2=6, P2=4, spread=24.0):
    c1 = rng.uniform(0, spread, (F, R1, 3))
    c2 = rng.uniform(0, spread, (F, R2, 3))
    pos1 = c1[:, :, None] + rng.normal(0, 1.0, (F, R1, P1, 3))
    pos2 = c2[:, :, None] + rng.normal(0, 1.0, (F, R2, P2, 3))
    pos = np.concatenate([pos1.reshape(F, -1, 3), pos2.reshape(F, -1, 3)],
                         axis=1).astype(np.float32)
    box = np.tile(np.array([25.0, 28.0, 30.0], np.float32), (F, 1))
    return (pos, box, np.repeat(np.arange(R1), P1),
            np.repeat(np.arange(R2) + 100, P2), R1 * P1)


def _batches(cls, pos, box, size):
    return [cls(np.arange(lo, min(lo + size, len(pos))),
                np.arange(lo, min(lo + size, len(pos))) * 0.1,
                pos[lo:lo + size], box[lo:lo + size])
            for lo in range(0, len(pos), size)]


@pytest.mark.parametrize("cfg", [dict(), dict(transfer_cap=8),
                                 dict(prefilter=True, upload_dtype="u16")])
def test_frame_sharded_rows_equal_unsharded_and_jax(cfg):
    """F = 11 frames in batches of 4 over 3 shards: every batch pads its
    frame axis (4 -> 6, 3 -> 3 of 1 each)."""
    pos, box, r1, r2, A1 = _system(np.random.default_rng(4), 11)
    idx1, idx2 = np.arange(A1), np.arange(A1, pos.shape[1])
    runs = {}
    for name, kw in (("one", dict(device="cpu")),
                     ("three", dict(device="cpu", n_devices=3)),
                     ("listed", dict(devices=["cpu", "cpu"]))):
        mt = tm.MapContacts(idx1, r1, idx2, r2, cfg=ContactConfig(**cfg),
                            meta=ContactMeta(ts=0.1), **kw)
        runs[name] = mt.run(_batches(FrameBatch, pos, box, 4))
        assert mt.stats["frames"] == 11 and mt.stats["batches"] == 3
        assert len(mt.devices) == {"one": 1, "three": 3, "listed": 2}[name]
    want = jm.MapContacts(idx1, r1, idx2, r2, cfg=JContactConfig(**cfg),
                          meta=JMeta(ts=0.1), n_devices=3).run(
        _batches(jm.FrameBatch, pos, box, 4))
    got, ref = runs["three"], runs["one"]
    assert len(got.frames) > 20
    for f in ("frames", "sel1_resids", "sel2_resids", "times", "min_dist"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(runs["listed"], f),
                                      getattr(ref, f))
    for f in ("frames", "sel1_resids", "sel2_resids", "times"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.min_dist, want.min_dist, atol=1e-4)
    assert got.meta.ts == ref.meta.ts


def test_frame_sharded_densities_equal_unsharded_and_jax():
    rng = np.random.default_rng(11)
    K, F, A = 4, 8 * 3 + 5, 23          # F not a multiple of the shards
    pos = rng.uniform(-2, 42, (F, A, 3)).astype(np.float32)
    w = rng.random((F, K)).astype(np.float32)
    mask = (rng.random((F, A)) < 0.85).astype(np.float32)
    ref = GridAccumulator(K, gridcenter=[20.0] * 3, device="cpu")
    ref.add(pos, w, mask=mask)
    sh = GridAccumulator(K, gridcenter=[20.0] * 3,
                         mesh=make_mesh(n_lanes=3, device="cpu"))
    sh.add(pos, w, mask=mask, frame_chunk=11)
    jsh = JGrid(K, gridcenter=[20.0] * 3,
                mesh=jmake_mesh(n_lanes=3, devices=jax.devices()[:3]))
    jsh.add(pos, w, mask=mask)
    spilled = sh._spilled.numpy()
    (g, _), (gr, _) = sh.finish(), ref.finish()
    assert gr.sum() > 0 and spilled.sum() > 0
    for other in (gr, jsh.grids):
        tol = 1e-5 * np.abs(other).max(axis=(1, 2, 3))
        assert (np.abs(g - other).max(axis=(1, 2, 3)) <= tol).all()
    np.testing.assert_allclose(spilled, ref._spilled.numpy(), rtol=1e-5)
    np.testing.assert_allclose(spilled, jsh._spilled, rtol=1e-5)
    # (F,) weights and no mask take the same path
    one = GridAccumulator(1, gridcenter=[20.0] * 3,
                          mesh=make_mesh(n_lanes=2, device="cpu"))
    one.add(pos, w[:, 0])
    base = GridAccumulator(1, gridcenter=[20.0] * 3, device="cpu")
    base.add(pos, w[:, 0])
    np.testing.assert_allclose(one.finish()[0], base.finish()[0],
                               rtol=0, atol=1e-5 * base.grids.max().item())


# ----------------------------------------------------------- distributed

_CLUSTER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "SLURM_JOB_NUM_NODES", "SLURM_NNODES",
                 "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


@pytest.fixture
def no_cluster(monkeypatch):
    for var in _CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(distributed, "_initialized", False)
    return monkeypatch


def test_single_process_noop_and_partition(no_cluster):
    distributed.initialize()      # nothing advertised: a no-op
    assert distributed._initialized and not dist.is_initialized()
    assert not distributed.is_multihost()
    assert distributed.host_residue_partition([3, 1, 2]) == [1, 2, 3]


def test_cluster_env_detection(no_cluster):
    mp = no_cluster
    assert not distributed._cluster_env_detected()
    mp.setenv("WORLD_SIZE", "4")          # no rendezvous address: not one
    assert not distributed._cluster_env_detected()
    mp.setenv("MASTER_ADDR", "10.0.0.1")
    assert distributed._cluster_env_detected()
    mp.setenv("WORLD_SIZE", "1")
    assert not distributed._cluster_env_detected()
    mp.delenv("MASTER_ADDR")
    for var in ("SLURM_JOB_NUM_NODES", "SLURM_NNODES",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        mp.setenv(var, "1")
        assert not distributed._cluster_env_detected()
        mp.setenv(var, "3")
        assert distributed._cluster_env_detected()
        mp.delenv(var)
    # the TPU runtime's variables are not a torch cluster
    mp.setenv("TPU_WORKER_HOSTNAMES", "host-0,host-1")
    mp.setenv("MEGASCALE_COORDINATOR_ADDRESS", "10.0.0.2")
    assert not distributed._cluster_env_detected()


def test_failed_join_under_an_advertised_cluster_surfaces(no_cluster):
    mp = no_cluster

    def refuse(*a, **kw):
        raise RuntimeError("connection refused")

    mp.setattr(dist, "init_process_group", refuse)
    mp.setenv("MASTER_ADDR", "10.0.0.1")
    mp.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="connection refused"):
        distributed.initialize()
    assert not distributed._initialized
    mp.delenv("MASTER_ADDR")
    # explicit arguments always surface their failure
    with pytest.raises(RuntimeError, match="connection refused"):
        distributed.initialize("tcp://127.0.0.1:1", world_size=2, rank=0)
    # Slurm across nodes with no rendezvous named: refuse, never run alone
    mp.setenv("SLURM_NNODES", "2")
    with pytest.raises(RuntimeError, match="advertises"):
        distributed.initialize()
    assert not distributed._initialized
    # MASTER_ADDR of a one-process job that cannot join: a no-op
    mp.delenv("SLURM_NNODES")
    mp.setenv("MASTER_ADDR", "10.0.0.1")
    mp.setenv("WORLD_SIZE", "1")
    distributed.initialize()
    assert distributed._initialized and not distributed.is_multihost()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_split_one_results_tree(tmp_path):
    """Two processes on localhost run ``gibbs --multihost`` on one event
    table: each joins the gloo group, samples its round-robin share of the
    five residues on the CPU and writes its own subtree."""
    cols = _table({r: 80 + 20 * r for r in range(1, 6)})
    path = str(tmp_path / "contacts_7.0.npz")
    ContactEvents(*cols, ContactMeta(cutoff=7.0)).save(path)
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "basicrta_torch.cli", "gibbs",
             "--contacts", path, "--engine", "torch", "--niter", "40",
             "--g", "10", "--ncomp", "3", "--nchains", "1", "--multihost"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    # rank 0 took residues 1, 3, 5, rank 1 residues 2, 4
    assert "X1:" in outs[0] and "X3:" in outs[0] and "X5:" in outs[0]
    assert "X2:" in outs[1] and "X4:" in outs[1]
    assert "X2:" not in outs[0] and "X1:" not in outs[1]
    done = sorted(os.listdir(tmp_path / "basicrta-7.0"))
    assert [d for d in done if not d.startswith(".")] == [
        f"X{i}" for i in range(1, 6)]
    for i in range(1, 6):
        assert (tmp_path / "basicrta-7.0" / f"X{i}" / "gibbs_40.npz").exists()


# ------------------------------------------------------------------- CLI

def test_cli_gibbs_ndevices(tmp_path, monkeypatch):
    cols = _table({10: 300, 20: 150})
    path = str(tmp_path / "contacts_7.0.npz")
    ContactEvents(*cols, ContactMeta(cutoff=7.0)).save(path)
    monkeypatch.chdir(tmp_path)
    cli.main(["gibbs", "--contacts", path, "--engine", "torch", "--niter",
              "40", "--g", "10", "--ncomp", "3", "--ndevices", "2"])
    for lab in ("X10", "X20"):
        g = Gibbs.load(str(tmp_path / "basicrta-7.0" / lab / "gibbs_40.npz"))
        assert g.mcweights.shape == (2, 4, 3) and np.isfinite(g.tau).all()


def test_cli_contacts_ndevices(tmp_path, monkeypatch):
    from basicrta_torch.io.native import XTCWriter
    from basicrta_torch.io.topology import Topology, write_gro
    pos, box, r1, r2, A1 = _system(np.random.default_rng(7), 13)
    n = pos.shape[1]
    names = np.array(["CA"] * A1 + ["C1"] * (n - A1))
    resnames = np.array(["TRP"] * A1 + ["CHOL"] * (n - A1))
    resids = np.concatenate([r1 + 1, r2]).astype(np.int32)
    gro = write_gro(str(tmp_path / "s.gro"),
                    Topology(names, resids, resnames, pos[0], box[0]))
    xtc = str(tmp_path / "s.xtc")
    XTCWriter(xtc).write(pos, np.arange(13) * 0.1, box)
    out = {}
    for flag in ([], ["--ndevices", "2"]):
        d = tmp_path / ("sharded" if flag else "plain")
        d.mkdir()
        monkeypatch.chdir(d)
        cli.main(["contacts", "--top", gro, "--traj", xtc, "--sel1",
                  "resname TRP", "--sel2", "resname CHOL", "--cutoff", "7.0",
                  "--batch", "5", "--device", "cpu", *flag])
        out[bool(flag)] = ContactRecords.load(str(d / "contacts.npz"))
    assert len(out[True].frames) > 20
    for f in ("frames", "sel1_resids", "sel2_resids", "times", "min_dist"):
        np.testing.assert_array_equal(getattr(out[True], f),
                                      getattr(out[False], f))
