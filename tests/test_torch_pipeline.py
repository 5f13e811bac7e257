"""The whole slice of basicrta_torch on the CPU, against the JAX package:
buckets, run_batch draw for draw with the fused engine's interpret path,
the CLI ``gibbs`` + ``cluster`` on a 3-residue event table, artifacts that
load in either package, checkpoints, and the guards (no jax import, no
silent CPU fallback for the CUDA engine)."""

import os
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, see conftest)
import numpy as np
import pytest
import torch

from basicrta_tpu import cli as jcli
from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.ops.surv import discretize_times, simulate_hyperexp
from basicrta_tpu.sampler import batch as jbatch
from basicrta_tpu.sampler.gibbs import Gibbs as JGibbs
from basicrta_torch import cli
from basicrta_torch.contacts.records import ContactEvents, ContactMeta
from basicrta_torch.interop import from_jax_batch, to_numpy, to_state
from basicrta_torch.sampler import batch
from basicrta_torch.sampler.gibbs import Gibbs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _times(n, seed, w=(0.85, 0.15), r=(2.0, 0.1)):
    return discretize_times(simulate_hyperexp(
        n, list(w), list(r), np.random.default_rng(seed)), 0.1)


@pytest.mark.parametrize("sizes", [(3000, 800, 200), (50, 20000, 5, 1200)])
def test_bucket_residues_equals_jax_pow2(sizes):
    times = {f"R{i}": _times(n, i) for i, n in enumerate(sizes)}
    times["empty"] = np.zeros(0)
    got = batch.bucket_residues(times, ladder="pow2")
    ref = jbatch.bucket_residues(times, ladder="pow2")
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.names == b.names and a.tiers == b.tiers
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.n_events, b.n_events)
        c = from_jax_batch(b)
        assert c.names == a.names and c.tiers == a.tiers


def test_run_batch_draws_the_jax_fused_chain():
    """Same cfg.seed: the plain engine draws what the JAX fused engine
    draws in interpret mode (same bucket salt, reseeding and hash)."""
    times = {"A1": _times(2500, 7), "B2": _times(900, 8)}
    jb = jbatch.bucket_residues(times, floor=256)[0]
    cfg = GibbsConfig(ncomp=4, niter=20, g=10, seed=5)
    ref = jbatch.run_batch(jb, cfg, engine="pallas")
    got = batch.run_batch(from_jax_batch(jb), cfg, engine="torch")
    assert got.mcweights.shape == ref.mcweights.shape == (2, 2, 4)
    same = [np.allclose(got.mcweights[b], ref.mcweights[b], rtol=1e-4)
            and np.allclose(got.mcrates[b], ref.mcrates[b], rtol=1e-4)
            for b in range(2)]
    assert sum(same) >= 1, same


def test_run_batch_checkpoint_resume(tmp_path):
    times = {"A1": _times(1500, 9)}
    b = batch.bucket_residues(times, ladder="pow2")[0]
    cfg = GibbsConfig(ncomp=4, niter=60, g=10, seed=9)
    full = batch.run_batch(b, cfg, segment_blocks=2, engine="torch")
    ckpt = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def bomb(seg_idx, state, _):
        if seg_idx == 2:
            raise Stop

    with pytest.raises(Stop):
        batch.run_batch(b, cfg, segment_blocks=2, checkpoint_path=ckpt,
                        checkpoint_cb=bomb, engine="torch")
    key = "basicrta_torch-torch"
    assert batch.load_checkpoint(ckpt, b, cfg, key)[0] == 4
    # the engine tag keeps the JAX package's checkpoints apart
    assert batch.load_checkpoint(ckpt, b, cfg, "xla") is None
    resumed = batch.run_batch(b, cfg, segment_blocks=3, checkpoint_path=ckpt,
                              engine="torch")
    np.testing.assert_array_equal(resumed.mcweights, full.mcweights)
    np.testing.assert_array_equal(resumed.mcrates, full.mcrates)
    assert not os.path.exists(ckpt)


def test_cuda_engine_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    b = batch.bucket_residues({"A1": _times(300, 1)}, ladder="pow2")[0]
    cfg = GibbsConfig(ncomp=3, niter=20, g=10)
    with pytest.raises(RuntimeError, match="CUDA device"):
        batch.run_batch(b, cfg, engine="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        batch.run_batch(b, cfg, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        batch.run_batch(b, cfg, engine="pallas")
    with pytest.raises(ValueError, match="unknown engine"):
        batch.resolve_engine("auto")
    # the default is the card: without one it raises, never falls back
    with pytest.raises(RuntimeError, match="CUDA device"):
        batch.resolve_engine()
    with pytest.raises(RuntimeError, match="CUDA device"):
        batch.run_batch(b, cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        batch.run_residues({"A1": _times(300, 1)}, cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Gibbs(_times(300, 1), residue="A1", cutoff=7.0, cfg=cfg).run()
    with pytest.raises(SystemExit):
        cli.main(["gibbs", "--contacts", "x.npz", "--engine", "auto"])
    # the CPU only when the caller asks for it
    assert batch.resolve_engine(device="cpu") == ("torch",
                                                  torch.device("cpu"))
    assert batch.resolve_engine("torch") == ("torch", torch.device("cpu"))
    assert batch.run_batch(b, cfg, device="cpu").mcweights.shape == (1, 2, 3)


def test_import_and_cpu_slice_leave_jax_out(tmp_path):
    code = (
        "import sys, numpy as np\n"
        "import basicrta_torch, basicrta_torch.cli, basicrta_torch.interop\n"
        "from basicrta_torch.config import GibbsConfig\n"
        "from basicrta_torch.sampler.gibbs import Gibbs\n"
        "x = np.repeat(np.arange(1, 60) * 0.1, 5)\n"
        "g = Gibbs(x, residue='X1', cutoff=7.0, root=sys.argv[1],\n"
        "          cfg=GibbsConfig(ncomp=3, niter=40, g=10, burnin=10,\n"
        "                          gmm_n_init=2)).run(engine='torch')\n"
        "g.process_gibbs(); g.estimate_tau(); Gibbs.load(g.save())\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules\n"
        "                                        if m.startswith('jax'))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_interop_round_trip():
    st = to_state((np.ones((2, 3)), np.full((2, 3), 2.0)))
    assert st.weights.dtype == torch.float32
    w, r = to_numpy(st)
    np.testing.assert_array_equal(r, np.full((2, 3), 2.0, np.float32))


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """CLI gibbs + cluster of both packages on one 3-residue table (plus a
    residue too small to sample)."""
    sizes = {10: 3000, 20: 800, 30: 300, 40: 6}
    resids = np.concatenate([np.full(n, r, np.int32)
                             for r, n in sizes.items()])
    dur = np.concatenate([_times(n, r) for r, n in sizes.items()])
    events = ContactEvents(resids, np.zeros_like(resids),
                           np.zeros_like(dur), dur, ContactMeta(cutoff=7.0))
    args = ["--niter", "600", "--g", "10", "--ncomp", "4", "--nchains", "2"]
    out = {}
    cwd = os.getcwd()
    for name, mod, engine in (("torch", cli, "torch"), ("jax", jcli, "xla")):
        d = tmp_path_factory.mktemp(name)
        path = str(d / "contacts_7.0.npz")
        events.save(path)
        os.chdir(d)
        try:
            mod.main(["gibbs", "--contacts", path, *args, "--engine",
                      engine])
            if name == "torch":
                cli.main(["cluster", "--cutoff", "7.0", "--niter", "600"])
            else:
                from basicrta_tpu.protein.driver import ProcessProtein
                ProcessProtein(cfg=GibbsConfig(niter=600),
                               cutoff=7.0).write_data()
        finally:
            os.chdir(cwd)
        out[name] = d
    return out


def test_cli_slice_cis_overlap_jax(slice_runs):
    t = np.load(slice_runs["torch"] / "tausout.npy")
    j = np.load(slice_runs["jax"] / "tausout.npy")
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    assert list(t[:, 0]) == [10, 20, 30, 40]
    for (_, tau, lo, hi), (_, jtau, jlo, jhi) in zip(t[:3], j[:3]):
        assert np.isfinite([tau, lo, hi]).all() and 0 < lo <= hi
        assert lo <= jhi and jlo <= hi, (lo, hi, jlo, jhi)
    np.testing.assert_array_equal(t[3], [40, 0, 0, 0])    # too small


def test_status_reports_skipped(slice_runs, capsys, monkeypatch):
    monkeypatch.chdir(slice_runs["torch"])
    cli.main(["status", "--cutoff", "7.0", "--niter", "600"])
    assert "done: 3  missing: 0  skipped: 1" in capsys.readouterr().out


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_artifacts_load_in_either_package(slice_runs, writer):
    path = slice_runs[writer] / "basicrta-7.0" / "X10" / "gibbs_600.npz"
    a, b = Gibbs.load(str(path)), JGibbs.load(str(path))
    # each package has its own GibbsConfig class; their JSON is one form
    assert a.cfg.to_json() == b.cfg.to_json()
    assert a.processed.lmode == b.processed.lmode
    np.testing.assert_array_equal(a.mcweights, b.mcweights)
    np.testing.assert_array_equal(a.processed.labels, b.processed.labels)
    assert a.tau == b.tau


def test_driver_input_errors(tmp_path):
    from basicrta_torch.protein.driver import (ParallelGibbs,
                                               cutoff_from_filename,
                                               residue_labels_for)
    with pytest.raises(FileNotFoundError):
        ParallelGibbs(str(tmp_path / "contacts_7.0.npz"))
    ev = ContactEvents(np.array([1], np.int32), np.array([2], np.int32),
                       np.zeros(1), np.ones(1), ContactMeta())
    with pytest.raises(ValueError, match="cutoff"):
        ParallelGibbs(ev)
    assert cutoff_from_filename("/x/contacts_6.5.npz") == 6.5
    top = tmp_path / "top.gro"
    top.write_text("")
    ev.meta.top = str(top)
    # an unreadable topology: the loud fallback to X-prefixed labels
    with pytest.warns(UserWarning, match="X-prefixed labels"):
        assert residue_labels_for(ev, np.array([313])) == ["X313"]


def test_from_jax_batch_refuses_packed_buckets():
    """Packed and mixed buckets carry over with their layout; only a
    malformed one (widths that do not match its pack or members) is
    refused."""
    import dataclasses
    times = {f"R{i}": _times(60, i) for i in range(40)}
    packed = [b for b in jbatch.bucket_residues(times) if b.pack > 1]
    assert packed
    for jb in packed:
        b = from_jax_batch(jb)
        assert (b.pack, b.phys_rows) == (jb.pack, jb.phys_rows)
    mixed = next(b for b in packed if b.bounds is not None)
    bad = dataclasses.replace(mixed, bounds=mixed.bounds[:, :1])
    with pytest.raises(ValueError, match="malformed"):
        from_jax_batch(bad)


def test_split_by_residue_equals_times_for_residue():
    """The one-pass split gives every residue exactly the durations, in
    table order, that a per-residue mask gives."""
    rng = np.random.default_rng(4)
    n = 5000
    resids = rng.choice([3, 7, 11, 40, 41], size=n).astype(np.int32)
    ev = ContactEvents(resids, np.zeros(n, np.int32), np.zeros(n),
                       rng.random(n), ContactMeta(cutoff=7.0))
    split = ev.split_by_residue()
    assert sorted(split) == [3, 7, 11, 40, 41]
    for r in (3, 7, 11, 40, 41):
        np.testing.assert_array_equal(split[r], ev.times_for_residue(r))
    some = ev.split_by_residue(np.array([7, 99]))
    np.testing.assert_array_equal(some[7], ev.times_for_residue(7))
    assert some[99].shape == (0,)
    assert ev.times_per_residue().keys() == split.keys()
