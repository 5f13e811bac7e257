"""Buckets interleaved, a segment of all at a time (``run_residues`` /
``run_batches``), against each bucket alone (``run_batch``): bitwise the
same samples on the CPU engine, for the pow2 and the production layout,
with and without checkpoints, and resumed from checkpoints written
mid-run. Plus the two host helpers of the redesigned kernels: K3's
per-slot column ranges and the block's thread count, and the checkpoint
guard: a checkpoint of another workload, another engine or the JAX
package is refused (``tests/test_aux.py::TestCheckpointResume``).
"""

import os

import numpy as np
import pytest
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch, cuda_sweep as cs


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small eager steps: with torch's intra-op threads, each step
    waits for threads that the suite's other workers keep busy. One
    thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = GibbsConfig(ncomp=3, niter=30, g=10, seed=4)


def _times(ladder):
    """A small protein with several buckets on ``ladder``: for the
    production layout 36 residues log-uniform in 10^2..10^4.7 events (x 2
    chains: two mixed buckets), for the pow2 ladder 7 small residues and a
    wide one (three buckets)."""
    if ladder == "pow2":
        rng = np.random.default_rng(1)
        out = {}
        for i, m in enumerate(rng.integers(15, 500, 7)):
            x = rng.exponential(1.0 + i, int(m))
            out[f"R{i}"] = np.maximum(np.round(x / 0.1), 1.0) * 0.1
        out["BIG"] = np.repeat(np.arange(1, 700) * 0.1,
                               rng.integers(1, 30, 699))
        return out
    rng = np.random.default_rng(4)
    w = np.array([0.87, 0.09, 0.03, 0.009, 0.001])
    r = np.array([4.7, 1.3, 0.33, 0.06, 0.009])
    out = {}
    for i, size in enumerate((10 ** rng.uniform(2.0, 4.7, 36)).astype(int)):
        comp = rng.choice(5, size=size, p=w)
        x = -np.log(rng.random(size)) / (r * rng.uniform(0.7, 1.5))[comp]
        out[f"R{i}"] = np.maximum(np.round(np.sort(x) / 0.1), 1.0) * 0.1
    return out


@pytest.fixture(scope="module", params=["pow2", None])
def protein(request):
    """(ladder, times, {lane name: (W, R)} from run_batch on each bucket,
    one bucket after another)."""
    ladder = request.param
    times = _times(ladder)
    lanes = {f"{k}#{c}": t for k, t in times.items() for c in range(2)}
    buckets = batch.bucket_residues(lanes, ladder=ladder)
    assert len(buckets) >= 2
    ref = {}
    for b in buckets:
        res = batch.run_batch(b, CFG, segment_blocks=2, engine="torch")
        for i, name in enumerate(res.names):
            ref[name] = (res.mcweights[i], res.mcrates[i])
    return ladder, times, ref, len(buckets)


def _assert_same(got, ref, n_chains=2):
    assert len(got) * n_chains == len(ref)
    for name, (W, R) in got.items():
        for ch in range(n_chains):
            np.testing.assert_array_equal(W[ch], ref[f"{name}#{ch}"][0])
            np.testing.assert_array_equal(R[ch], ref[f"{name}#{ch}"][1])


@pytest.mark.parametrize("checkpoints", [False, True])
def test_interleaved_buckets_equal_buckets_in_series(tmp_path, protein,
                                                     checkpoints):
    ladder, times, ref, _ = protein
    seen = []
    got = batch.run_residues(
        times, CFG, n_chains=2, ladder=ladder, engine="torch",
        segment_blocks=1,
        checkpoint_dir=str(tmp_path) if checkpoints else None,
        progress_cb=lambda done, total: seen.append((done, total)))
    _assert_same(got, ref)
    # one call a round of all buckets, not one a bucket
    assert seen == [(10, 30), (20, 30), (30, 30)]
    assert not os.listdir(tmp_path)      # finished runs leave no checkpoint


def test_interleaved_buckets_resume_bitwise(tmp_path, protein):
    ladder, times, ref, n_buckets = protein
    rounds = []

    def bomb(done, total):
        rounds.append(done)
        if done == 10:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        batch.run_residues(times, CFG, n_chains=2, ladder=ladder,
                           engine="torch", segment_blocks=1,
                           checkpoint_dir=str(tmp_path), progress_cb=bomb)
    assert len(os.listdir(tmp_path)) == n_buckets
    # another segmentation from the checkpoints on
    got = batch.run_residues(times, CFG, n_chains=2, ladder=ladder,
                             engine="torch", segment_blocks=2,
                             checkpoint_dir=str(tmp_path),
                             progress_cb=lambda d, t: rounds.append(d))
    _assert_same(got, ref)
    assert rounds == [10, 30]


def test_run_batches_equals_run_batch_each():
    lanes = {f"{k}#0": t for k, t in _times("pow2").items()}
    buckets = batch.bucket_residues(lanes, ladder="pow2")
    assert len(buckets) >= 2
    together = batch.run_batches(buckets, CFG, segment_blocks=2,
                                 engine="torch")
    for b, res in zip(buckets, together):
        alone = batch.run_batch(b, CFG, engine="torch")
        assert res.names == alone.names
        np.testing.assert_array_equal(res.mcweights, alone.mcweights)
        np.testing.assert_array_equal(res.mcrates, alone.mcrates)


def test_checkpoint_rejects_mismatched_workload(tmp_path):
    """The port's ``load_checkpoint`` resumes only its own workload: not
    another seed, other residence times, another engine tag, nor a JAX
    checkpoint of the same bucket; and the JAX package refuses the port's.
    ``run_batch`` given a refused checkpoint samples from the start."""
    from basicrta_tpu.config import GibbsConfig as JGibbsConfig
    from basicrta_tpu.sampler import batch as jbatch
    from basicrta_tpu.sampler.kernels import MixtureState as JState
    from basicrta_torch.sampler.kernels import init_mixture_params

    x = _times("pow2")["R0"]
    b = batch.bucket_residues({"A1": x})[0]
    jb = jbatch.bucket_residues({"A1": x})[0]
    np.testing.assert_array_equal(b.values, jb.values)
    cfg = GibbsConfig(ncomp=4, niter=100, g=10)
    jcfg = JGibbsConfig(ncomp=4, niter=100, g=10)
    st = init_mixture_params(4)
    state = type(st)(st.weights[None], st.rates[None])
    tag = "basicrta_torch-torch"
    p = batch.save_checkpoint(str(tmp_path / "c.npz"), b, cfg, 5, 1, state,
                              [], [], tag)
    got = batch.load_checkpoint(p, b, cfg, tag)
    assert got is not None and got[:2] == (5, 1)
    np.testing.assert_array_equal(got[2].weights, state.weights.numpy())
    other = batch.bucket_residues({"A1": x * 2.0})[0]
    for args in ((b, GibbsConfig(ncomp=4, niter=100, g=10, seed=77), tag),
                 (other, cfg, tag), (b, cfg, "basicrta_torch-cuda"),
                 (b, cfg, "basicrta_torch-collapsed")):
        assert batch.load_checkpoint(p, *args) is None
    # the JAX package's checkpoint of the same bucket, and the reverse
    jstate = JState(np.asarray(state.weights), np.asarray(state.rates))
    for engine in ("xla", "pallas"):
        jp = jbatch.save_checkpoint(str(tmp_path / f"j{engine}.npz"), jb,
                                    jcfg, 5, 1, jstate, [], [], engine)
        assert jbatch.load_checkpoint(jp, jb, jcfg, engine) is not None
        assert jbatch.load_checkpoint(
            jp, jb, JGibbsConfig(ncomp=4, niter=100, g=10, seed=77),
            engine) is None
        for t in ("basicrta_torch-torch", "basicrta_torch-cuda",
                  "basicrta_torch-collapsed"):
            assert batch.load_checkpoint(jp, b, cfg, t) is None
        assert jbatch.load_checkpoint(p, jb, jcfg, engine) is None
    # the refused file is ignored by the run, which starts from sweep 0
    small = GibbsConfig(ncomp=3, niter=30, g=10, seed=4)
    fresh = batch.run_batch(b, small, engine="torch")
    ck = str(tmp_path / "jxla.npz")
    again = batch.run_batch(b, small, engine="torch", checkpoint_path=ck)
    np.testing.assert_array_equal(again.mcweights, fresh.mcweights)
    np.testing.assert_array_equal(again.mcrates, fresh.mcrates)

def test_slot_ranges_of_the_mixed_packing():
    """The ranges read off _pack_mixed's slot tile are the running
    offsets of the widths; empty slots and unowned columns own nothing."""
    rng = np.random.default_rng(0)
    widths = np.array([[40, 30, 20, 0], [64, 0, 64, 0], [10, 10, 10, 10],
                       [128, 0, 0, 0]])
    SL = 2
    B = int((widths > 0).sum())
    vals = rng.uniform(0.1, 9.0, (B, 256)).astype(np.float32)
    cnts = np.zeros((B, 256), np.float32)
    for i, w in enumerate(widths[widths > 0]):
        cnts[i, :SL * w] = rng.integers(1, 30, SL * w)
    _, c_ph, seg_id, _ = batch._pack_mixed(vals, cnts, widths, SL)
    got = cs.slot_ranges(torch.tensor(seg_id).to(torch.int64), 4).numpy()
    for g in range(len(widths)):
        off = 0
        for s, w in enumerate(widths[g]):
            if w == 0:
                if (s, g) == (1, 1):      # an empty slot between two others
                    assert tuple(got[g, s]) == (0, 0)
                continue
            assert tuple(got[g, s]) == (off, off + w), (g, s)
            off += w
        # every live column lies inside its slot's range
        live = np.nonzero(c_ph[g].any(0))[0]
        own = seg_id[g, live].astype(int)
        assert ((live >= got[g, own, 0]) & (live < got[g, own, 1])).all()


@pytest.mark.parametrize("pack", [2, 4, 8, 16])
def test_slot_ranges_of_the_uniform_packing(pack):
    W = 128 // pack
    st = cs.MixtureState(torch.ones(2 * pack, 3), torch.ones(2 * pack, 3))
    v = torch.ones(2 * pack, 3 * W)
    _, _, slot = cs._packed_operands(st, v, v.clone(), 3, (0, 0), pack, None)
    got = cs.slot_ranges(slot, pack)
    want = torch.tensor([[s * W, (s + 1) * W] for s in range(pack)])
    assert torch.equal(got, want.expand(2, pack, 2))


@pytest.mark.parametrize("tree", [False, True])
def test_block_threads_are_whole_rows_within_bounds(tree):
    cap = 512 if tree else 1024
    for SL in range(1, 200):
        t = cs.block_threads(SL, tree)
        assert t % 128 == 0 and 128 <= t <= cap
        # a thread per column up to the bound: every block row has a row,
        # and no lane takes more turns than the bound forces
        assert t == min(128 * SL, cap)
    assert cs.block_threads(8) == 1024 and cs.block_threads(12) == 1024
    assert cs.block_threads(3) == 384 and cs.block_threads(1) == 128
    assert cs.block_threads(12, tree=True) == 512
