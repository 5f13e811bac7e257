"""Sharded sampling of basicrta_torch (``parallel.mesh`` behind
``run_batch(sharding=...)`` and ``process_residues_batched(sharding=...)``)
on the CPU, against the JAX package's multi-device runs on its 8 virtual
CPU devices (``tests/conftest.py``): mesh shapes, ``deal_columns`` exactly,
the lane-sharded plain K2/K3 draw for draw with JAX's lane-sharded Pallas
engine in interpret mode, a one-shard mesh bitwise the unsharded run,
checkpoints that name the mesh and resume exactly, the refusals, the
event-sharded collapsed engine in law, and sharded post-processing
exactly.

As in test_torch_packed.py, residence times are multiples of 0.25 ns so
that T_k sums are exact in f32 in either reduction order; a 1-ulp
difference between XLA's fused code and torch's op-by-op arithmetic may
move a lane onto another valid chain, so >= 95% of lanes must agree.
"""

import os
import zlib

import jax
import numpy as np
import pytest
import torch

from basicrta_tpu.config import GibbsConfig as JConfig
from basicrta_tpu.parallel import mesh as jmesh
from basicrta_tpu.sampler import batch as jbatch
from basicrta_torch.config import GibbsConfig
from basicrta_torch.interop import from_jax_batch
from basicrta_torch.parallel import mesh
from basicrta_torch.postprocess import batched
from basicrta_torch.sampler import batch


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Chains are many small eager steps: with torch's intra-op threads,
    each step waits for threads that the suite's other workers keep busy.
    One thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n_lanes, n_events=1):
    return mesh.make_mesh(n_lanes=n_lanes, n_events=n_events, device="cpu")


def _times(n, seed, dt=0.25):
    """A two-component hyperexponential sample on a 0.25 ns grid."""
    rng = np.random.default_rng(seed)
    k = int(n * 0.8)
    x = np.concatenate([rng.exponential(1 / 2.0, k),
                        rng.exponential(1 / 0.1, n - k)])
    return np.maximum(np.ceil(x / dt), 1) * dt


def _mixed_bucket(seed):
    """A JAX mixed-width bucket by hand: three physical lanes of 3 rows
    (a 3-member lane, a lane with one member and two empty slots, a
    2-member lane), members multiplicity-sorted with head, small and
    singleton columns."""
    rng = np.random.default_rng(seed)
    widths = np.array([[50, 40, 30], [100, 0, 0], [64, 60, 0]], np.int64)
    SL = 3
    vals, cnts = [], []
    for w in widths[widths > 0]:
        V = int(rng.integers(SL * w - w + 1, SL * w + 1))
        c = np.concatenate([rng.integers(17, 400, int(w) // 3),
                            rng.integers(2, 17, int(w)),
                            rng.integers(0, 2, V - int(w) // 3 - int(w))])
        vals.append(rng.integers(1, 121, V) * 0.25)
        cnts.append(np.sort(c)[::-1].astype(np.float64))
    Vm = max(len(v) for v in vals)
    values, counts = np.ones((len(vals), Vm)), np.zeros((len(vals), Vm))
    for i, (v, c) in enumerate(zip(vals, cnts)):
        values[i, :len(v)], counts[i, :len(c)] = v, c
    _, tiers = jbatch.compute_tiers(counts)
    return jbatch.ResidueBatch([f"M{i}" for i in range(len(vals))], values,
                               counts, counts.sum(1).astype(np.int64),
                               tiers, pack=3, bounds=widths, phys_rows=SL)


def _jax_bucket(kind):
    if kind == "unpacked":
        times = {f"A{i}": _times(n, i) for i, n in enumerate((400, 300, 500))}
        return jbatch.bucket_residues(times, floor=128)[0]
    if kind == "uniform":
        times = {f"B{i}": _times(n, 10 + i)
                 for i, n in enumerate((300, 200, 400, 250))}
        (b,) = [b for b in jbatch.bucket_residues(times, consolidate=False)
                if b.pack > 1]
        return b
    return _mixed_bucket(3)


def test_make_mesh_shapes():
    m = _cpu_mesh(4, 2)
    assert m.shape == {"lanes": 4, "events": 2}
    assert m.shape == dict(jmesh.make_mesh(n_lanes=4, n_events=2).shape)
    assert mesh.make_mesh(devices=["cpu"] * 8).shape["lanes"] == 8
    assert mesh.make_mesh(device="cpu").shape == {"lanes": 1, "events": 1}
    assert mesh.make_mesh(devices=["cpu"] * 4, n_events=2).shape == {
        "lanes": 2, "events": 2}
    assert m.axis_devices("lanes") == [torch.device("cpu")] * 4
    sh = mesh.event_sharding(m)
    assert (sh.n_lanes, sh.n_events) == (4, 2)
    assert mesh.lane_sharding(m).n_events == 1
    with pytest.raises(ValueError, match="needs 6 devices"):
        mesh.make_mesh(n_lanes=3, n_events=2, devices=["cpu"] * 4)


@pytest.mark.parametrize("V,E,tiers", [(16, 4, (3, 10)), (24, 3, (0, 7)),
                                       (128, 2, (5, 128)), (12, 1, (2, 4))])
def test_deal_columns_equals_jax(V, E, tiers):
    rng = np.random.default_rng(V + E)
    counts = -np.sort(-rng.integers(0, 50, (3, V)), axis=1).astype(float)
    values = rng.uniform(0.1, 9.0, (3, V))
    got = mesh.deal_columns(values, counts, E, tiers)
    want = jmesh.deal_columns(values, counts, E, tiers)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    for e in range(E):
        assert np.all(np.diff(got[1][:, e * V // E:(e + 1) * V // E]) <= 0)
    for fn in (mesh.deal_columns, jmesh.deal_columns):
        with pytest.raises(ValueError, match="not divisible"):
            fn(values[:, :V - 1], counts[:, :V - 1], 2, tiers)


@pytest.mark.parametrize("kind", ["unpacked", "uniform", "mixed"])
def test_lane_sharded_plain_engine_draws_the_jax_sharded_chain(kind):
    """Two lane shards: shard s launches on its own lanes at seed0 + s *
    0x3504F333, as JAX's shard_map over the fused engine does; the chains
    differ from the unsharded run's."""
    jb = _jax_bucket(kind)
    assert (jb.pack > 1) == (kind != "unpacked")
    assert (jb.bounds is not None) == (kind == "mixed")
    cfg = GibbsConfig(ncomp=3, niter=20, g=10, seed=4)
    jcfg = JConfig(ncomp=3, niter=20, g=10, seed=4)
    ref = jbatch.run_batch(jb, jcfg, engine="pallas",
                           sharding=jmesh.lane_sharding(jmesh.make_mesh(
                               n_lanes=2, devices=jax.devices()[:2])))
    b = from_jax_batch(jb)
    got = batch.run_batch(b, cfg, engine="torch",
                          sharding=mesh.lane_sharding(_cpu_mesh(2)))
    assert got.mcweights.shape == ref.mcweights.shape == (b.size, 2, 3)
    same = [np.allclose(got.mcweights[i], ref.mcweights[i], rtol=1e-4)
            and np.allclose(got.mcrates[i], ref.mcrates[i], rtol=1e-4)
            for i in range(b.size)]
    assert np.mean(same) >= 0.95, same
    unsharded = batch.run_batch(b, cfg, engine="torch")
    assert not np.allclose(unsharded.mcweights, got.mcweights)


@pytest.mark.parametrize("engine,kind", [("torch", "unpacked"),
                                         ("torch", "mixed"),
                                         ("collapsed", "uniform")])
def test_one_shard_mesh_is_the_unsharded_run(engine, kind):
    b = from_jax_batch(_jax_bucket(kind))
    cfg = GibbsConfig(ncomp=3, niter=20, g=10, seed=6)
    a = batch.run_batch(b, cfg, engine=engine, device="cpu")
    one = batch.run_batch(b, cfg, engine=engine,
                          sharding=mesh.lane_sharding(_cpu_mesh(1)))
    np.testing.assert_array_equal(one.mcweights, a.mcweights)
    np.testing.assert_array_equal(one.mcrates, a.mcrates)


class _Stop(Exception):
    pass


def _bomb(at):
    def cb(seg_idx, state, _):
        if seg_idx == at:
            raise _Stop
    return cb


@pytest.mark.parametrize("engine,kind,n_events", [("torch", "mixed", 1),
                                                  ("collapsed", "uniform", 2)])
def test_sharded_run_resumes_exactly_and_names_the_mesh(tmp_path, engine,
                                                        kind, n_events):
    b = from_jax_batch(_jax_bucket(kind))
    tag = f"basicrta_torch-{engine}-l2" + ("-ev2" if n_events > 1 else "")
    tag += f"-p{b.pack}"
    if b.bounds is not None:
        tag += f"-mx{zlib.crc32(b.bounds.tobytes()) & 0xffff:04x}"
    cfg = GibbsConfig(ncomp=3, niter=40, g=10, seed=8)
    sh = (mesh.event_sharding(_cpu_mesh(2, n_events)) if n_events > 1
          else mesh.lane_sharding(_cpu_mesh(2)))
    # the kernels reseed every sweep, so their chain is the same for any
    # segmentation; the collapsed engine's generator is a segment's
    seg = (3, 2) if engine == "torch" else (1, 1)
    full = batch.run_batch(b, cfg, segment_blocks=seg[0], engine=engine,
                           sharding=sh)
    ckpt = str(tmp_path / "ck.npz")
    with pytest.raises(_Stop):
        batch.run_batch(b, cfg, segment_blocks=1, checkpoint_path=ckpt,
                        checkpoint_cb=_bomb(2), engine=engine, sharding=sh)
    assert batch.load_checkpoint(ckpt, b, cfg, tag)[0] == 2
    unsharded_tag = tag.replace("-l2", "").replace("-ev2", "")
    assert batch.load_checkpoint(ckpt, b, cfg, unsharded_tag) is None
    resumed = batch.run_batch(b, cfg, segment_blocks=seg[1],
                              checkpoint_path=ckpt, engine=engine,
                              sharding=sh)
    np.testing.assert_array_equal(resumed.mcweights, full.mcweights)
    np.testing.assert_array_equal(resumed.mcrates, full.mcrates)
    assert not os.path.exists(ckpt)


def test_run_residues_names_its_checkpoints_by_the_mesh(tmp_path):
    times = {"A": _times(300, 1), "B": _times(200, 2)}
    cfg = GibbsConfig(ncomp=3, niter=40, g=10, seed=2)
    sh = mesh.lane_sharding(_cpu_mesh(2))
    with pytest.raises(_Stop):
        batch.run_residues(times, cfg, checkpoint_dir=str(tmp_path),
                           engine="torch", sharding=sh, segment_blocks=1,
                           checkpoint_cb=_bomb(1))
    (b,) = batch.bucket_residues({f"{k}#0": v for k, v in times.items()},
                                 ladder="pow2")
    key = batch._checkpoint_key(b, cfg, "basicrta_torch-torch-l2")
    assert os.listdir(tmp_path) == [f"ckpt_{key}.npz"]
    out = batch.run_residues(times, cfg, checkpoint_dir=str(tmp_path),
                             engine="torch", sharding=sh, segment_blocks=1)
    ref = batch.run_residues(times, cfg, engine="torch", sharding=sh)
    for name in times:
        np.testing.assert_array_equal(out[name][0], ref[name][0])


def test_kernel_engines_refuse_event_shards_and_missing_cards(monkeypatch):
    b = from_jax_batch(_jax_bucket("unpacked"))
    cfg = GibbsConfig(ncomp=3, niter=20, g=10)
    ev = mesh.event_sharding(_cpu_mesh(2, 2))
    for engine in ("cuda", "torch"):
        with pytest.raises(ValueError, match="events"):
            batch.run_batch(b, cfg, engine=engine, sharding=ev)
    # the JAX package refuses the same for its fused engine
    with pytest.raises(ValueError, match="events"):
        jbatch.run_batch(_jax_bucket("unpacked"), JConfig(ncomp=3, niter=20,
                                                          g=10),
                         engine="pallas", sharding=jmesh.event_sharding(
                             jmesh.make_mesh(n_lanes=2, n_events=2,
                                             devices=jax.devices()[:4])))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        batch.run_batch(b, cfg, engine="cuda",
                        sharding=mesh.lane_sharding(_cpu_mesh(2)))
    with pytest.raises(ValueError, match="disagree"):
        batch.run_batch(b, cfg, engine="collapsed", device="cuda",
                        sharding=mesh.lane_sharding(_cpu_mesh(2)))
    with pytest.raises(RuntimeError, match="CUDA device"):
        mesh.make_mesh(n_lanes=2)
    # more devices than visible cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices asked for, 1 cards"):
        mesh.make_mesh(n_lanes=2)
    assert mesh.local_devices() == [torch.device("cuda", 0)]


def _dominant(res, burn):
    out = []
    for W, R in zip(res.mcweights, res.mcrates):
        k = W[burn:].mean(0).argmax()
        out.append((W[burn:, k].mean(), R[burn:, k].mean()))
    return out


def test_event_sharded_collapsed_run_matches_unsharded_in_law():
    """JAX's test_event_sharded_run_batch on the collapsed engine: 4 lanes
    of one 5,000-event residue over 2 lanes x 2 event shards."""
    x = _times(5000, 9, dt=0.1)
    b = batch.bucket_residues({f"L{i}": x for i in range(4)}, floor=256)[0]
    cfg = GibbsConfig(ncomp=4, niter=400, g=10, burnin=100, seed=9)
    res = batch.run_batch(b, cfg, engine="collapsed",
                          sharding=mesh.event_sharding(_cpu_mesh(2, 2)))
    ref = batch.run_batch(b, cfg, engine="collapsed", device="cpu")
    for (w, r), (wr, rr) in zip(_dominant(res, cfg.burnin_samples),
                                _dominant(ref, cfg.burnin_samples)):
        assert w == pytest.approx(wr, rel=0.05)
        assert r == pytest.approx(rr, rel=0.08)


def test_event_sharded_odd_ncomp_and_direct_step():
    """K = 5 over 2 event shards (K is never dealt: the state stays whole);
    and the step itself: a 1 x 1 mesh's draws equal a 1 x 2 mesh's in
    shape, finite, state on the first device."""
    x = _times(1000, 2, dt=0.1)
    b = batch.bucket_residues({"L0": x}, floor=256)[0]
    cfg = GibbsConfig(ncomp=5, niter=100, g=10, burnin=0, seed=2)
    res = batch.run_batch(b, cfg, engine="collapsed",
                          sharding=mesh.event_sharding(_cpu_mesh(1, 2)))
    assert res.mcweights.shape == (1, 10, 5)
    assert np.isfinite(res.mcweights).all() and np.isfinite(
        res.mcrates).all()
    np.testing.assert_allclose(res.mcweights.sum(-1), 1.0, rtol=1e-5)
    step = mesh.sharded_training_step(_cpu_mesh(1, 2), cfg, n_blocks=2)
    from basicrta_torch.sampler.kernels import (MixtureState,
                                                init_mixture_params)
    st0 = init_mixture_params(5)
    st = MixtureState(st0.weights.repeat(2, 1), st0.rates.repeat(2, 1))
    v = torch.as_tensor(np.tile(b.values, (2, 1)), dtype=torch.float32)
    c = torch.as_tensor(np.tile(b.counts, (2, 1)), dtype=torch.float32)
    st1, W, R = step(7, st, v, c)
    assert W.shape == R.shape == (2, 2, 5) and st1.weights.shape == (2, 5)
    assert torch.equal(W[:, -1], st1.weights)
    st2, W2, _ = step(7, st, v, c)
    assert torch.equal(W, W2)                 # seeded: reproducible


def _fake_residue(rng, n_events, S=60, K=8):
    W = rng.uniform(1e-7, 1e-6, (S, K))
    R = rng.uniform(0.5, 2.0, (S, K))
    for k, (w, r) in enumerate(((0.7, 5.0), (0.3, 0.05))):
        W[:, k] = w * np.exp(rng.normal(0.0, 0.05, S))
        R[:, k] = r * np.exp(rng.normal(0.0, 0.05, S))
    raw = np.where(rng.random(n_events) < 0.7,
                   rng.exponential(1.0 / 5.0, n_events),
                   rng.exponential(1.0 / 0.05, n_events))
    values, counts = np.unique(np.maximum(np.round(raw / 0.1), 1.0) * 0.1,
                               return_counts=True)
    return W[None], R[None], values, counts.astype(np.float64)


def test_sharded_postprocessing_equals_unsharded():
    rng = np.random.default_rng(42)
    items = {f"R{i}": _fake_residue(rng, n)
             for i, n in enumerate([800, 1500, 3000, 700, 2500])}
    cfg = GibbsConfig(ncomp=8, niter=6000, g=100, burnin=1000, gmm_n_init=8)
    ref = batched.process_residues_batched(items, cfg, device="cpu")
    got = batched.process_residues_batched(
        items, cfg, sharding=mesh.lane_sharding(_cpu_mesh(3)))
    assert list(got) == list(ref)
    for name in items:
        assert got[name].lmode == ref[name].lmode
        np.testing.assert_array_equal(got[name].labels, ref[name].labels)
        np.testing.assert_array_equal(got[name].pindicator_values,
                                      ref[name].pindicator_values)
