"""Card-only tests of the CUDA kernels: each kernel (K1, K2, the packed
K3, the PRNG probe K5) against its plain PyTorch version on the same CUDA
tensors, exact resume, checkpoints written behind the next launch, the
run_batch engine on packed and mixed buckets, batched post-processing on
the card, the span recorder's clock against
the profiler's device events and its on/off equality, and launch refusals.
They skip without a CUDA device.

This file imports no JAX (the card's machine has none); run it there with

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch, cuda_sweep
from basicrta_torch.sampler.kernels import MixtureState, init_mixture_params
from basicrta_torch.scripts import device_prng

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _bucket(B, V, K, tiers, seed, dev):
    rng = np.random.default_rng(seed)
    h, s = tiers
    vals = rng.uniform(0.1, 30.0, (B, V))
    cnts = np.concatenate([rng.integers(17, 4000, (B, 128 * h)),
                           rng.integers(2, 17, (B, 128 * (s - h))),
                           rng.integers(0, 2, (B, V - 128 * s))], 1)
    st = init_mixture_params(K, device=dev)
    return (MixtureState(st.weights.repeat(B, 1), st.rates.repeat(B, 1)),
            torch.tensor(vals, dtype=torch.float32, device=dev),
            torch.tensor(cnts, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("shape", [(4, 384, 4, (1, 2)), (2, 1024, 15, (2, 4)),
                                   (256, 128, 15, (0, 1)),
                                   (3, 512, 32, (0, 0))])
def test_kernels_match_plain(dev, shape):
    B, V, K, tiers = shape
    st, v, c = _bucket(B, V, K, tiers, 5, dev)
    ns, ts = cuda_sweep.sweep_stats(11, st, v, c, K, tiers)
    pn, pt = cuda_sweep.sweep_stats_torch(11, st, v, c, K, tiers)
    assert torch.equal(ns.sum(1), c.sum(1))
    assert (ns == pn).float().mean().item() >= 0.99
    same = (ns == pn).all(1)
    torch.testing.assert_close(ts[same], pt[same], rtol=1e-4, atol=1e-3)
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    _, W, R = cuda_sweep.segment(5, 0, st, v, c, cfg, 2, tiers)
    _, W2, R2 = cuda_sweep.segment_torch(5, 0, st, v, c, cfg, 2, tiers)
    ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
          & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))
    assert ok.float().mean().item() >= 0.95


def test_kernel_exact_resume(dev):
    st, v, c = _bucket(8, 256, 6, (1, 1), 6, dev)
    cfg = GibbsConfig(ncomp=6, niter=40, g=10)
    s4, W4, R4 = cuda_sweep.segment(9, 0, st, v, c, cfg, 4, (1, 1))
    s1, Wa, Ra = cuda_sweep.segment(9, 0, st, v, c, cfg, 1, (1, 1))
    s3, Wb, Rb = cuda_sweep.segment(9, cfg.g, s1, v, c, cfg, 3, (1, 1))
    assert torch.equal(torch.cat([Wa, Wb], 1), W4)
    assert torch.equal(torch.cat([Ra, Rb], 1), R4)
    assert torch.equal(s3.weights, s4.weights)


def test_launch_counters(dev):
    st, v, c = _bucket(2, 128, 3, (0, 1), 7, dev)
    before = (cuda_sweep.segment.launches, cuda_sweep.segment_torch.calls)
    cuda_sweep.segment(1, 0, st, v, c, GibbsConfig(ncomp=3, niter=2, g=1), 2,
                       (0, 1))
    assert (cuda_sweep.segment.launches,
            cuda_sweep.segment_torch.calls) == (before[0] + 1, before[1])


def test_run_batch_cuda_engine(dev):
    x = np.repeat(np.arange(1, 300) * 0.1, 4)
    b = batch.bucket_residues({"A1": x, "B2": x[::3]})
    cfg = GibbsConfig(ncomp=5, niter=200, g=10, seed=2)
    for bk in b:
        res = batch.run_batch(bk, cfg, segment_blocks=7, engine="cuda")
        assert res.mcweights.shape == (bk.size, 20, 5)
        assert np.isfinite(res.mcweights).all()
        np.testing.assert_allclose(res.mcweights.sum(-1), 1.0, rtol=1e-5)


def test_kernel_refuses_malformed_operands(dev):
    st, v, c = _bucket(2, 128, 3, (0, 1), 8, dev)
    with pytest.raises(ValueError, match="one CUDA"):
        cuda_sweep.sweep_stats(0, st, v, c.cpu(), 3, (0, 1))
    big = init_mixture_params(33, device=dev)
    big = MixtureState(big.weights.repeat(2, 1), big.rates.repeat(2, 1))
    with pytest.raises(ValueError, match="K <= 32"):
        cuda_sweep.sweep_stats(0, big, v, c, 33, (0, 1))


def _mixed_bucket(dev, K, seed=9):
    """A mixed-width k-way bucket of the production layout, as the kernel
    takes it: (state, values, counts, tiers, seg_id, members' slots)."""
    rng = np.random.default_rng(seed)
    times = {f"R{i}#{c}": np.repeat(np.arange(1, n) * 0.1,
                                    rng.integers(1, 40, n - 1))
             for i, n in enumerate(rng.integers(20, 400, 24))
             for c in range(2)}
    b = next(x for x in batch.bucket_residues(times) if x.bounds is not None)
    vals, cnts, tiers, seg_id, slot, Bs = batch._kernel_layout(b)
    st = init_mixture_params(K, device=dev)
    return (MixtureState(st.weights.repeat(Bs, 1), st.rates.repeat(Bs, 1)),
            torch.tensor(vals, device=dev), torch.tensor(cnts, device=dev),
            tiers, torch.tensor(seg_id, device=dev), b.pack,
            torch.tensor(slot, device=dev))


def test_packed_kernel_matches_plain(dev):
    K = 15
    st, v, c, tiers, seg, pack, slot = _mixed_bucket(dev, K)
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    _, W, R = cuda_sweep.segment_packed(5, 0, st, v, c, cfg, 2, tiers, pack,
                                        seg)
    _, W2, R2 = cuda_sweep.segment_packed_torch(5, 0, st, v, c, cfg, 2,
                                                tiers, pack, seg)
    ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
          & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))[slot]
    assert ok.float().mean().item() >= 0.95
    # uniform pack 4: logical lanes straight in
    st4, v4, c4 = _bucket(8, 128, K, (1, 1), 3, dev)
    _, W, _ = cuda_sweep.segment_packed(5, 0, st4, v4[:, :96], c4[:, :96],
                                        cfg, 2, (3, 3), 4)
    _, W2, _ = cuda_sweep.segment_packed_torch(5, 0, st4, v4[:, :96],
                                               c4[:, :96], cfg, 2, (3, 3), 4)
    assert torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1).float().mean(
        ).item() >= 0.95


def test_packed_kernel_exact_resume(dev):
    st, v, c, tiers, seg, pack, _ = _mixed_bucket(dev, 6, seed=4)
    cfg = GibbsConfig(ncomp=6, niter=40, g=10)
    s4, W4, R4 = cuda_sweep.segment_packed(9, 0, st, v, c, cfg, 4, tiers,
                                           pack, seg)
    s1, Wa, Ra = cuda_sweep.segment_packed(9, 0, st, v, c, cfg, 1, tiers,
                                           pack, seg)
    s3, Wb, Rb = cuda_sweep.segment_packed(9, cfg.g, s1, v, c, cfg, 3, tiers,
                                           pack, seg)
    assert torch.equal(torch.cat([Wa, Wb], 1), W4)
    assert torch.equal(torch.cat([Ra, Rb], 1), R4)
    assert torch.equal(s3.weights, s4.weights)


def test_run_batch_packed_buckets(dev):
    rng = np.random.default_rng(2)
    times = {f"R{i}": np.repeat(np.arange(1, n) * 0.1,
                                rng.integers(1, 30, n - 1))
             for i, n in enumerate(rng.integers(10, 300, 12))}
    cfg = GibbsConfig(ncomp=5, niter=200, g=10, seed=2)
    before = cuda_sweep.segment_packed.launches
    for layout in (batch.bucket_residues(times),
                   batch.bucket_residues(times, consolidate=False)):
        for bk in layout:
            res = batch.run_batch(bk, cfg, segment_blocks=7, engine="cuda")
            assert res.mcweights.shape == (bk.size, 20, 5)
            assert np.isfinite(res.mcweights).all()
            np.testing.assert_allclose(res.mcweights.sum(-1), 1.0, rtol=1e-5)
    assert cuda_sweep.segment_packed.launches > before


@pytest.mark.parametrize("shape", [(3, 1280, 6, (2, 5)),
                                   (2, 2176, 15, (3, 9)),
                                   (2, 1152, 4, (0, 2))])
def test_wide_lanes_take_turns(dev, shape):
    """Lanes of more than 1,024 columns, with a row count that the
    block's 8 rows do not divide: 10 rows (a second turn, backwards, for
    two block rows), 17 (a third turn for one) and 9. N_k totals stay
    exact."""
    B, V, K, tiers = shape
    assert V > 1024
    st, v, c = _bucket(B, V, K, tiers, 21, dev)
    for tree in (False, True):
        ns, ts = cuda_sweep.sweep_stats(11, st, v, c, K, tiers, tree=tree)
        pn, pt = cuda_sweep.sweep_stats_torch(11, st, v, c, K, tiers,
                                              tree=tree)
        assert torch.equal(ns.sum(1), c.sum(1))
        assert (ns == pn).float().mean().item() >= 0.99
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    s2, W, R = cuda_sweep.segment(5, 0, st, v, c, cfg, 2, tiers)
    _, W2, R2 = cuda_sweep.segment_torch(5, 0, st, v, c, cfg, 2, tiers)
    ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
          & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))
    assert ok.all()
    s1, Wa, _ = cuda_sweep.segment(5, 0, st, v, c, cfg, 1, tiers)
    s1, Wb, _ = cuda_sweep.segment(5, 1, s1, v, c, cfg, 1, tiers)
    assert torch.equal(torch.cat([Wa, Wb], 1), W)
    assert torch.equal(s1.rates, s2.rates)


@pytest.mark.parametrize("SL", [5, 11])
def test_packed_pack12_with_empty_slots(dev, SL):
    """Mixed pack 12 with empty slots (in the middle and at the end) and
    unowned columns, on 5 rows (640 threads) and 11 (1,024 threads, a
    second turn for three block rows): every slot, the empty ones too,
    against the plain version; bitwise resume."""
    rng = np.random.default_rng(SL)
    K, pack = 15, 12
    widths = np.array([[10] * 12, [20, 0, 20, 0, 20, 0, 20, 0, 20, 0, 0, 0],
                       [7, 9, 11, 13, 15, 17, 19, 0, 0, 0, 0, 0],
                       [64, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]])
    B, Vmax = int((widths > 0).sum()), SL * 64
    vals = np.ones((B, Vmax), np.float32)
    cnts = np.zeros((B, Vmax), np.float32)
    for i, w in enumerate(widths[widths > 0]):
        n = SL * w - int(rng.integers(0, w))
        vals[i, :n] = rng.uniform(0.1, 30.0, n)
        raw = np.concatenate([rng.integers(17, 4000, n // 4),
                              rng.integers(2, 17, n // 3),
                              np.ones(n - n // 4 - n // 3)])
        cnts[i, :n] = np.sort(raw)[::-1]
    v_ph, c_ph, seg_id, slot = batch._pack_mixed(vals, cnts, widths, SL)
    tiers = batch._mixed_row_tiers(c_ph)
    assert 0 < tiers[0] < tiers[1] < SL
    Bph = len(widths)
    v = torch.tensor(v_ph.reshape(Bph, -1), device=dev)
    c = torch.tensor(c_ph.reshape(Bph, -1), device=dev)
    seg = torch.tensor(seg_id, device=dev)
    st0 = init_mixture_params(K, device=dev)
    st = MixtureState(st0.weights.repeat(Bph * pack, 1),
                      st0.rates.repeat(Bph * pack, 1))
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    for tree in (False, True):
        s2, W, R = cuda_sweep.segment_packed(5, 0, st, v, c, cfg, 2, tiers,
                                             pack, seg, tree=tree)
        _, W2, R2 = cuda_sweep.segment_packed_torch(5, 0, st, v, c, cfg, 2,
                                                    tiers, pack, seg,
                                                    tree=tree)
        ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
              & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))
        assert ok.float().mean().item() >= 0.95
        assert ok[torch.tensor(slot, device=dev)].float().mean() >= 0.95
        s1, Wa, Ra = cuda_sweep.segment_packed(5, 0, st, v, c, cfg, 1, tiers,
                                               pack, seg, tree=tree)
        s1, Wb, Rb = cuda_sweep.segment_packed(5, 1, s1, v, c, cfg, 1, tiers,
                                               pack, seg, tree=tree)
        assert torch.equal(torch.cat([Wa, Wb], 1), W)
        assert torch.equal(torch.cat([Ra, Rb], 1), R)
        assert torch.equal(s1.weights, s2.weights)


def test_packed_kernel_refuses_scattered_slots(dev):
    """A slot whose live columns are not one contiguous range is the plain
    version's business, not the kernel's."""
    st, v, c = _bucket(2, 128, 3, (0, 1), 8, dev)
    st = MixtureState(st.weights.repeat(2, 1), st.rates.repeat(2, 1))
    seg = (torch.arange(128, device=dev) % 2).float().expand(2, 128)
    cfg = GibbsConfig(ncomp=3, niter=1, g=1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sweep.segment_packed(1, 0, st, v, c, cfg, 1, (0, 1), 2,
                                  seg.contiguous())


def test_run_residues_buckets_on_streams_equal_run_batch(dev):
    """Every bucket on a stream of its own gives each bucket's own
    chain."""
    rng = np.random.default_rng(6)
    times = {f"R{i}": np.repeat(np.arange(1, n) * 0.1,
                                rng.integers(1, 30, n - 1))
             for i, n in enumerate(rng.integers(10, 900, 30))}
    cfg = GibbsConfig(ncomp=5, niter=200, g=10, seed=2)
    lanes = {f"{k}#{ch}": t for k, t in times.items() for ch in range(2)}
    buckets = batch.bucket_residues(lanes, ladder="pow2")
    assert len(buckets) >= 3
    got = batch.run_residues(times, cfg, n_chains=2, ladder="pow2",
                             engine="cuda", segment_blocks=7)
    for b in buckets:
        res = batch.run_batch(b, cfg, segment_blocks=20, engine="cuda")
        for i, name in enumerate(res.names):
            k, ch = name.rsplit("#", 1)
            np.testing.assert_array_equal(got[k][0][int(ch)],
                                          res.mcweights[i])
            np.testing.assert_array_equal(got[k][1][int(ch)], res.mcrates[i])


def test_checkpoints_written_behind_the_next_segment_on_the_card(
        dev, tmp_path):
    """K2 with a checkpoint written while the next segment runs: the
    samples bitwise those of one launch with nothing in flight beside it
    (and of the run without checkpoints), every checkpoint but the last's
    counted ``behind``, each holding its own segment's state, from which a
    resume is bitwise the whole run."""
    from basicrta_torch import spans
    rng = np.random.default_rng(8)
    times = {f"R{i}": np.repeat(rng.uniform(0.1, 30.0, n),
                                rng.integers(1, 30, n))
             for i, n in enumerate((300, 900))}
    lanes = {f"{k}#{c}": t for k, t in times.items() for c in range(2)}
    b = batch.bucket_residues(lanes, ladder="pow2")[-1]
    cfg = GibbsConfig(ncomp=5, niter=400, g=10, seed=5)
    whole = batch.run_batch(b, cfg, segment_blocks=40, engine="cuda")
    bare = batch.run_batch(b, cfg, segment_blocks=8, engine="cuda")
    ckpt = str(tmp_path / "ck.npz")
    states = {}

    def keep(seg_idx, state, _):
        states[seg_idx] = state
        if os.path.exists(ckpt):
            os.replace(ckpt, str(tmp_path / f"seg{seg_idx}.npz"))

    spans.drain()
    spans.enable()
    try:
        got = batch.run_batch(b, cfg, segment_blocks=8, engine="cuda",
                              checkpoint_path=ckpt, checkpoint_cb=keep)
    finally:
        spans.disable()
    marks = [s for s in spans.drain() if s.name == "sampler.checkpoint"]
    for res in (bare, got):
        np.testing.assert_array_equal(res.mcweights, whole.mcweights)
        np.testing.assert_array_equal(res.mcrates, whole.mcrates)
    assert len(marks) == 4 and all(s.attrs["behind"] == 1 for s in marks)
    assert sorted(states) == [1, 2, 3, 4, 5]
    for n in (1, 4):
        path = str(tmp_path / f"seg{n}.npz")
        done, _, ck, Ws, _ = batch.load_checkpoint(path, b, cfg,
                                                   "basicrta_torch-cuda")
        assert done == 8 * n
        np.testing.assert_array_equal(
            ck.weights, states[n].weights[:b.size].cpu().numpy())
        np.testing.assert_array_equal(Ws[0], whole.mcweights[:, :8 * n])
        resumed = batch.run_batch(b, cfg, segment_blocks=8, engine="cuda",
                                  checkpoint_path=path)
        np.testing.assert_array_equal(resumed.mcweights, whole.mcweights)
        np.testing.assert_array_equal(resumed.mcrates, whole.mcrates)


def test_prng_kernel_matches_plain(dev):
    u = device_prng.draw_kernel("uniform", 97, device=dev)
    assert torch.equal(u, device_prng.draw_plain("uniform", 97, device=dev))
    for kind, n, p, a in (("binom_lgamma", 5000, 0.47, 0),
                          ("binom_h4", 50, 0.3, 0), ("gamma", 0, 0, 3.7)):
        x = device_prng.draw_kernel(kind, 5, n, p, a, device=dev)
        y = device_prng.draw_plain(kind, 5, n, p, a, device=dev)
        assert torch.isclose(x, y, rtol=1e-4).float().mean().item() >= 0.999


def test_batched_postprocessing_on_the_card(dev):
    from basicrta_torch.postprocess.batched import process_residues_batched
    rng = np.random.default_rng(1)
    items = {}
    for i, n in enumerate((900, 2500, 6000)):
        S, K = 60, 6
        W = rng.uniform(1e-7, 1e-6, (1, S, K))
        R = rng.uniform(0.5, 2.0, (1, S, K))
        W[0, :, 0] = 0.7 * np.exp(rng.normal(0, 0.05, S))
        W[0, :, 1] = 0.3 * np.exp(rng.normal(0, 0.05, S))
        R[0, :, 0] = 5.0 * np.exp(rng.normal(0, 0.05, S))
        R[0, :, 1] = 0.05 * np.exp(rng.normal(0, 0.05, S))
        x = np.where(rng.random(n) < 0.7, rng.exponential(0.2, n),
                     rng.exponential(20.0, n))
        v, c = np.unique(np.maximum(np.round(x / 0.1), 1) * 0.1,
                         return_counts=True)
        items[f"R{i}"] = (W, R, v, c.astype(np.float64))
    cfg = GibbsConfig(ncomp=6, niter=6000, g=100, burnin=1000, gmm_n_init=8)
    res = process_residues_batched(items, cfg, device=dev)
    for r in res.values():
        assert r.lmode == 2
        np.testing.assert_allclose(r.pindicator_values.sum(1), 1.0,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 384, 5, (1, 2)), (2, 1024, 15, (2, 4)),
                                   (256, 128, 15, (0, 1)),
                                   (3, 512, 32, (0, 0))])
def test_tree_kernels_match_plain(dev, shape):
    """K4 in K1's and K2's kernels against the plain tree, K1/K2's rules."""
    B, V, K, tiers = shape
    st, v, c = _bucket(B, V, K, tiers, 15, dev)
    before = cuda_sweep.sweep_stats.tree_launches
    ns, ts = cuda_sweep.sweep_stats(11, st, v, c, K, tiers, tree=True)
    assert cuda_sweep.sweep_stats.tree_launches == before + 1
    pn, pt = cuda_sweep.sweep_stats_torch(11, st, v, c, K, tiers, tree=True)
    assert torch.equal(ns.sum(1), c.sum(1))
    assert (ns == pn).float().mean().item() >= 0.99
    same = (ns == pn).all(1)
    torch.testing.assert_close(ts[same], pt[same], rtol=1e-4, atol=1e-3)
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    _, W, R = cuda_sweep.segment(5, 0, st, v, c, cfg, 2, tiers, tree=True)
    _, W2, R2 = cuda_sweep.segment_torch(5, 0, st, v, c, cfg, 2, tiers,
                                         tree=True)
    ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
          & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))
    assert ok.float().mean().item() >= 0.95


def test_tree_packed_kernel_matches_plain_and_resumes(dev):
    K = 15
    st, v, c, tiers, seg, pack, slot = _mixed_bucket(dev, K)
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    s2, W, R = cuda_sweep.segment_packed(5, 0, st, v, c, cfg, 2, tiers, pack,
                                         seg, tree=True)
    _, W2, R2 = cuda_sweep.segment_packed_torch(5, 0, st, v, c, cfg, 2,
                                                tiers, pack, seg, tree=True)
    ok = (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
          & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))[slot]
    assert ok.float().mean().item() >= 0.95
    s1, Wa, Ra = cuda_sweep.segment_packed(5, 0, st, v, c, cfg, 1, tiers,
                                           pack, seg, tree=True)
    s1, Wb, Rb = cuda_sweep.segment_packed(5, 1, s1, v, c, cfg, 1, tiers,
                                           pack, seg, tree=True)
    assert torch.equal(torch.cat([Wa, Wb], 1), W)
    assert torch.equal(torch.cat([Ra, Rb], 1), R)
    assert torch.equal(s1.weights, s2.weights)
    # uniform pack 2: logical lanes straight in
    st2, v2, c2 = _bucket(8, 256, K, (1, 1), 4, dev)
    _, W, _ = cuda_sweep.segment_packed(5, 0, st2, v2[:, :128], c2[:, :128],
                                        cfg, 2, (1, 1), 2, tree=True)
    _, W2, _ = cuda_sweep.segment_packed_torch(5, 0, st2, v2[:, :128],
                                               c2[:, :128], cfg, 2, (1, 1),
                                               2, tree=True)
    assert torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1).float().mean(
        ).item() >= 0.95


def test_tree_kernel_exact_resume(dev):
    st, v, c = _bucket(8, 256, 6, (1, 1), 6, dev)
    cfg = GibbsConfig(ncomp=6, niter=40, g=10)
    s4, W4, R4 = cuda_sweep.segment(9, 0, st, v, c, cfg, 4, (1, 1), tree=True)
    s1, Wa, Ra = cuda_sweep.segment(9, 0, st, v, c, cfg, 1, (1, 1), tree=True)
    s3, Wb, Rb = cuda_sweep.segment(9, cfg.g, s1, v, c, cfg, 3, (1, 1),
                                    tree=True)
    assert torch.equal(torch.cat([Wa, Wb], 1), W4)
    assert torch.equal(torch.cat([Ra, Rb], 1), R4)
    assert torch.equal(s3.weights, s4.weights)


def test_ceiling_kernel_matches_plain(dev):
    from basicrta_torch.scripts import roofline
    s = roofline.CHECK_SCALE
    out = torch.empty((256, 128), device=dev)
    for iters, scale in ((20, s), (50, roofline.SCALE)):
        before = roofline.ceiling_tile.launches
        roofline.ceiling_tile(out, iters=iters, scale=scale)
        assert roofline.ceiling_tile.launches == before + 1
        ref = roofline.ceiling_tile_torch(iters, 64, device=dev, scale=scale)
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)
    # one step fewer must show at the check scale
    roofline.ceiling_tile(out, iters=19, scale=s)
    ref = roofline.ceiling_tile_torch(20, 64, device=dev, scale=s)
    assert not torch.allclose(out, ref, rtol=1e-5, atol=0)
    ceiling = roofline.transcendental_ceiling(dev)
    assert 1e11 < ceiling <= roofline.sfu_peak(roofline.max_sm_clock_mhz())


@pytest.mark.parametrize("kind,n,p,a", [("uniform", 0, 0, 0),
                                        ("binom_h4", 5000, 0.47, 0),
                                        ("binom_lgamma", 50, 0.3, 0),
                                        ("gamma", 0, 0, 3.7)])
def test_prng_many_tile_launch(dev, kind, n, p, a):
    """One launch over several tiles: tile t bitwise the one-tile launch at
    its seed, and the plain version's tile."""
    many = device_prng.draw_kernel(kind, 97, n, p, a, device=dev, tiles=5)
    assert many.shape == (5, device_prng.ROWS, 128)
    for t in (0, 3, 4):
        one = device_prng.draw_kernel(
            kind, 97 + t * device_prng.SEED_STRIDE, n, p, a, device=dev)
        assert torch.equal(many[t], one)
    plain = device_prng.draw_plain(kind, 97, n, p, a, device=dev, tiles=5)
    if kind == "uniform":
        assert torch.equal(many, plain)
    else:
        close = torch.isclose(many, plain, rtol=1e-4, atol=0)
        assert close.float().mean().item() >= 0.999
    out = torch.empty_like(many)
    assert device_prng.draw_kernel(kind, 97, n, p, a, device=dev, tiles=5,
                                   out=out) is out
    assert torch.equal(out, many)
    with pytest.raises(ValueError, match="out must be"):
        device_prng.draw_kernel(kind, 97, n, p, a, device=dev, tiles=4,
                                out=out)


def test_prng_stats_build(dev):
    """K5's counter build draws the same bits as the kernel, and its
    counters agree with its per-element trace."""
    for kind, n, p, a in device_prng.TIMED:
        out, got, old = device_prng.draw_stats(kind, 97, n, p, a, dev, 3)
        assert torch.equal(out, device_prng.draw_kernel(kind, 97, n, p, a,
                                                        dev, 3))
        assert got["lane_rounds"] == old["lane_rounds"] >= out.numel()
        assert got["slow_tests"] == old["slow_tests"]
        assert got["lane_slots"] <= old["lane_slots"]


def _contact_system(seed=3, F=6, R1=20, P1=5, R2=30, P2=4, spread=40.0):
    rng = np.random.default_rng(seed)
    c1 = rng.uniform(0, spread, (F, R1, 3))
    c2 = rng.uniform(0, spread, (F, R2, 3))
    pos = np.concatenate(
        [(c1[:, :, None] + rng.normal(0, 1.0, (F, R1, P1, 3))).reshape(
            F, -1, 3),
         (c2[:, :, None] + rng.normal(0, 1.0, (F, R2, P2, 3))).reshape(
            F, -1, 3)], axis=1).astype(np.float32)
    r1 = np.repeat(np.arange(R1), P1)
    r2 = np.repeat(np.arange(R2) + 100, P2)
    box = np.tile(np.array([41.0, 43.0, 45.0], np.float32), (F, 1))
    return pos, r1, r2, R1 * P1, box


@pytest.mark.parametrize("cfg", [
    dict(), dict(transfer_cap=64), dict(transfer_cap=2),
    dict(prefilter=True, prefilter_cap_min=16), dict(upload_dtype="u16"),
    dict(prefilter=True, prefilter_cap=8), dict(use_pbc=False)])
def test_contact_scan_on_the_card_equals_the_cpu(dev, cfg):
    """MapContacts through the pinned upload, the copy stream and the
    packed result copy gives the CPU scan's rows (distances to f32
    rounding), on every transfer path."""
    from basicrta_torch.config import ContactConfig
    from basicrta_torch.contacts.mapper import MapContacts
    from basicrta_torch.contacts.records import FrameBatch
    pos, r1, r2, A1, box = _contact_system()
    perm = np.random.default_rng(1).permutation(pos.shape[1])
    idx1, idx2 = np.sort(perm[:A1]), np.sort(perm[A1:])   # scattered
    recs = []
    for device in ("cpu", dev):
        mc = MapContacts(idx1, r1, idx2, r2, cfg=ContactConfig(**cfg),
                         device=device)
        mc.time_device = True
        recs.append(mc.run(
            [FrameBatch(np.arange(lo, lo + 2), np.arange(lo, lo + 2) * 0.1,
                        pos[lo:lo + 2], box[lo:lo + 2])
             for lo in range(0, 6, 2)]))
    assert mc.stats["device_s"] > 0 and mc.stats["frames"] == 6
    a, b = recs
    assert len(a) == len(b) > 0
    for f in ("frames", "sel1_resids", "sel2_resids", "times"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.min_dist, b.min_dist, atol=1e-5, rtol=0)


def test_contact_scan_on_the_card_against_the_host_version(dev):
    from basicrta_torch.contacts.mapper import MapContacts
    from basicrta_torch.contacts.records import FrameBatch
    from basicrta_torch.scripts import contacts_reference as ref
    pos, r1, r2, A1, box = _contact_system(seed=9)
    idx1, idx2 = np.arange(A1), np.arange(A1, pos.shape[1])
    rec = MapContacts(idx1, r1, idx2, r2).run(
        [FrameBatch(np.arange(6), np.arange(6) * 0.1, pos, box)])
    shared, lone, err = ref.check_records(
        rec, range(6), lambda f: (pos[f], box[f]), idx1, r1, idx2, r2, 10.0)
    assert shared > 0 and err <= 1e-4


def _density_chunks(seed=4, F=300, A=50, K=3):
    """Membrane-like rows: lipids in a 40 A cube around the origin, some
    atoms exactly on voxel edges, some outside the grid, ragged masks."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 8.0, (F, A, 3)).astype(np.float32)
    pos[:, :6] = rng.integers(-20, 21, (F, 6, 3)).astype(np.float32)
    pos[:, 6:9] += rng.choice([-40.0, 40.0], (F, 3, 3)).astype(np.float32)
    w = rng.dirichlet(np.ones(K), F).astype(np.float32)
    mask = (rng.random((F, A)) < 0.9).astype(np.float32)
    return pos, w, mask


def test_grid_accumulator_on_the_card_equals_the_cpu(dev):
    from basicrta_torch.kinetics.density import GridAccumulator
    pos, w, mask = _density_chunks()
    accs = {d: GridAccumulator(3, [0.0, 0.0, 0.0], delta=1.0, device=d)
            for d in ("cpu", dev)}
    for acc in accs.values():
        for lo in (0, 100, 200):
            acc.add(pos[lo:lo + 100], w[lo:lo + 100], mask[lo:lo + 100],
                    frame_chunk=64)
    with pytest.warns(UserWarning, match="outside the grid"):
        cpu, _ = accs["cpu"].finish()
    with pytest.warns(UserWarning, match="outside the grid"):
        card, _ = accs[dev].finish()
    np.testing.assert_allclose(card, cpu, rtol=0,
                               atol=1e-5 * np.abs(cpu).max())
    np.testing.assert_allclose(accs[dev]._spilled.cpu().numpy(),
                               accs["cpu"]._spilled.numpy(), rtol=1e-6)
    # every live atom's weight is in the grid or the spill bin
    total = card.reshape(3, -1).sum(1) + accs[dev]._spilled.cpu().numpy()
    np.testing.assert_allclose(total, (w[:, :, None] * mask[:, None, :])
                               .sum((0, 2)), rtol=1e-5)


def test_grid_stays_on_the_card_until_finish(dev):
    from basicrta_torch.kinetics.density import GridAccumulator
    pos, w, mask = (torch.as_tensor(x, device=dev)
                    for x in _density_chunks(seed=5))
    acc = GridAccumulator(3, [0.0, 0.0, 0.0], device=dev)
    torch.cuda.synchronize()
    # any device-to-host copy (or other synchronising call) in add raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        for lo in range(0, len(pos), 100):
            acc.add(pos[lo:lo + 100], w[lo:lo + 100], mask[lo:lo + 100],
                    frame_chunk=100)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert acc.grids.is_cuda and acc._spilled.is_cuda
    assert acc.grids.data_ptr() == acc._buf.data_ptr()
    with pytest.warns(UserWarning, match="outside the grid"):
        grids, _ = acc.finish()
    assert isinstance(grids, np.ndarray) and grids.shape == (3, 40, 40, 40)
    assert acc.n_rows == len(pos)


def test_samplers_on_the_card(dev):
    """torch's samplers on the card at the collapsed engine's edges: zero
    counts and probabilities 0 and 1, totals exact up to the flagship's
    multiplicities, and the prior's tiny gamma shapes clamped so that
    ``log`` stays finite."""
    from basicrta_torch.ops import random as tr
    gen = torch.Generator(device=dev).manual_seed(0)
    n = torch.tensor([0.0, 10.0, 10.0, 446605.0, 446605.0, 16.0], device=dev)
    p = torch.tensor([0.5, 0.0, 1.0, 1e-30, 0.999999, 1.0], device=dev)
    m = tr.binomial(n, p, gen).cpu().numpy()
    assert m[0] == 0 and m[1] == 0 and m[2] == 10 and m[5] == 16
    assert 0 <= m[3] <= 1 and 0 <= m[4] <= 446605
    probs = torch.tensor(np.random.default_rng(0).dirichlet(np.ones(15), 3),
                         dtype=torch.float32, device=dev)
    counts = torch.tensor([0.0, 7.0, 446605.0], device=dev)
    assert torch.equal(tr.multinomial(counts, probs, gen).sum(-1), counts)
    small = counts.clamp_max(16)
    assert torch.equal(tr.multinomial_small(small, probs, 16, gen).sum(-1),
                       small)
    for a in (1.0 / 15.0, 1e-3):
        g = tr.gamma(torch.full((100_000,), a, device=dev), gen)
        assert g.min().item() >= torch.finfo(torch.float32).tiny
        assert torch.isfinite(torch.log(g)).all()
    d = tr.dirichlet(torch.full((10_000, 15), 1.0 / 15.0, device=dev), gen)
    assert torch.isfinite(torch.log(d)).all()


def test_collapsed_engine_on_the_card(dev):
    """The reference collapsed sweep on the card: totals exact, log w
    finite and the softmax free of NaN through a run, and a resumed run
    bitwise the uninterrupted one."""
    from basicrta_torch.sampler import kernels
    rng = np.random.default_rng(8)
    times = {f"R{i}": np.repeat(np.arange(1, n) * 0.1,
                                rng.integers(1, 40, n - 1))
             for i, n in enumerate((300, 120, 700))}
    b = batch.bucket_residues(times, ladder="pow2")[-1]
    v = torch.as_tensor(b.values, dtype=torch.float32, device=dev)
    c = torch.as_tensor(b.counts, dtype=torch.float32, device=dev)
    cfg = GibbsConfig(ncomp=15, niter=200, g=10, seed=4)
    st0 = kernels.init_mixture_params(15, device=dev)
    st = kernels.MixtureState(st0.weights.repeat(b.size, 1),
                              st0.rates.repeat(b.size, 1))
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(50):
        st, m = kernels.collapsed_sweep(gen, st, v, c, cfg,
                                        return_counts=True, tiers=b.tiers)
        assert torch.equal(m.sum(-1), c)
        assert torch.isfinite(torch.log(st.weights)).all()
        assert not torch.isnan(torch.softmax(
            kernels._log_responsibilities(st, v), -1)).any()
    full = batch.run_batch(b, cfg, segment_blocks=5, engine="collapsed")
    assert full.mcweights.shape == (b.size, 20, 15)
    assert np.isfinite(np.log(full.mcweights)).all()


def test_collapsed_engine_resumes_bitwise_on_the_card(dev, tmp_path):
    rng = np.random.default_rng(9)
    times = {"A1": np.repeat(np.arange(1, 400) * 0.1,
                             rng.integers(1, 30, 399))}
    b = batch.bucket_residues(times, ladder="pow2")[0]
    cfg = GibbsConfig(ncomp=5, niter=60, g=10, seed=9)
    full = batch.run_batch(b, cfg, segment_blocks=2, engine="collapsed")
    ckpt = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def bomb(seg_idx, state, _):
        if seg_idx == 2:
            raise Stop

    with pytest.raises(Stop):
        batch.run_batch(b, cfg, segment_blocks=2, checkpoint_path=ckpt,
                        checkpoint_cb=bomb, engine="collapsed")
    resumed = batch.run_batch(b, cfg, segment_blocks=2, checkpoint_path=ckpt,
                              engine="collapsed")
    np.testing.assert_array_equal(resumed.mcweights, full.mcweights)
    np.testing.assert_array_equal(resumed.mcrates, full.mcrates)


@pytest.mark.parametrize("mode", ["collapsed", "dense"])
def test_gibbs_reference_modes_on_the_card(dev, mode):
    from basicrta_torch.sampler.gibbs import Gibbs
    x = np.repeat(np.arange(1, 300) * 0.1,
                  np.random.default_rng(2).integers(1, 20, 299))
    cfg = GibbsConfig(ncomp=4, niter=200, g=10, burnin=50, n_chains=2)
    g = Gibbs(x, residue="A1", cutoff=7.0, cfg=cfg).run(mode=mode,
                                                        save=False)
    assert g.device.type == "cuda"
    assert g.mcweights.shape == (2, 20, 4)
    assert np.isfinite(np.log(g.mcweights)).all()


def test_lane_shards_on_one_card(dev):
    """Two lane shards on one card (a mesh that names it twice): K3 per
    shard against the plain engine's sharded run on the same card, a
    one-shard mesh bitwise the unsharded run, and the frame-sharded
    densities equal to one device's."""
    from basicrta_torch.kinetics.density import GridAccumulator
    from basicrta_torch.parallel.mesh import lane_sharding, make_mesh
    rng = np.random.default_rng(9)
    times = {f"R{i}#{c}": np.repeat(np.arange(1, n) * 0.1,
                                    rng.integers(1, 40, n - 1))
             for i, n in enumerate(rng.integers(20, 400, 24))
             for c in range(2)}
    b = next(x for x in batch.bucket_residues(times) if x.bounds is not None)
    cfg = GibbsConfig(ncomp=6, niter=20, g=10, seed=3)
    two = lane_sharding(make_mesh(n_lanes=2, devices=[dev, dev]))
    cuda_sweep.segment_packed.launches = 0
    got = batch.run_batch(b, cfg, engine="cuda", sharding=two)
    assert cuda_sweep.segment_packed.launches == 2
    plain = batch.run_batch(b, cfg, engine="torch", sharding=two)
    ok = [np.allclose(got.mcweights[i], plain.mcweights[i], rtol=1e-4)
          and np.allclose(got.mcrates[i], plain.mcrates[i], rtol=1e-4)
          for i in range(b.size)]
    assert np.mean(ok) >= 0.95
    one = batch.run_batch(b, cfg, engine="cuda",
                          sharding=lane_sharding(make_mesh(n_lanes=1)))
    ref = batch.run_batch(b, cfg, engine="cuda")
    np.testing.assert_array_equal(one.mcweights, ref.mcweights)
    pos = rng.normal(0.0, 6.0, (1001, 20, 3)).astype(np.float32)
    w = rng.random((1001, 3)).astype(np.float32)
    grids = []
    for mesh in (None, make_mesh(n_lanes=2, devices=[dev, dev])):
        acc = GridAccumulator(3, [0.0, 0.0, 0.0], mesh=mesh)
        acc.add(pos, w, frame_chunk=300)
        grids.append(acc.finish()[0])
    peak = np.abs(grids[0]).max(axis=(1, 2, 3))
    assert (np.abs(grids[1] - grids[0]).max(axis=(1, 2, 3))
            <= 1e-5 * peak).all()


def test_deferred_run_batch_bitwise_eager_on_the_card(dev):
    """``run_batch(defer_transfer=True)`` + ``finalize_batch`` on K3 and K2
    buckets: one CUDA event a shard, samples bitwise the eager call's."""
    rng = np.random.default_rng(4)
    times = {f"R{i}": np.repeat(np.arange(1, n) * 0.1,
                                rng.integers(1, 30, n - 1))
             for i, n in enumerate(rng.integers(20, 600, 30))}
    cfg = GibbsConfig(ncomp=5, niter=40, g=10, seed=2)
    for b in (batch.bucket_residues(times)
              + batch.bucket_residues(times, ladder="pow2")[:1]):
        eager = batch.run_batch(b, cfg, engine="cuda")
        handle = batch.run_batch(b, cfg, engine="cuda", defer_transfer=True)
        assert len(handle.events) == 1
        late = batch.finalize_batch(handle)
        np.testing.assert_array_equal(eager.mcweights, late.mcweights)
        np.testing.assert_array_equal(eager.mcrates, late.mcrates)


def test_timings_change_nothing_on_the_card(dev):
    """``process_residues_batched(timings={})`` on the card: the four keys,
    outputs bitwise those without the hook."""
    from basicrta_torch.postprocess.batched import process_residues_batched
    from basicrta_torch.sampler.kernels import dedup_times
    from basicrta_torch.scripts.postbench import same_results
    rng = np.random.default_rng(5)
    items = {}
    for i in range(4):
        v, c = dedup_times(np.round(rng.exponential(1.0, 800), 1) + 0.1)
        items[f"R{i}"] = (rng.dirichlet([6.0, 2.0, 0.5, 0.5], (1, 40)),
                          rng.gamma(2.0, 1.0, (1, 40, 4)), v, c)
    cfg = GibbsConfig(ncomp=4, niter=400, g=10, burnin=50, gmm_n_init=6)
    plain = process_residues_batched(items, cfg, device=dev)
    t = {}
    timed = process_residues_batched(items, cfg, device=dev, timings=t)
    assert set(t) == {"host_prep_s", "gmm_s", "votes_s", "finish_s"}
    assert same_results(plain, timed)


def test_spans_share_the_device_trace_clock(dev):
    """A span around a kernel and a synchronize, under ``torch.profiler``
    with device activities only, holds the kernel's start and end within
    0.5 ms: spans and device events are on one clock. Under a profiler
    alone a span adds no device event, with host activities too (the
    trace ``chip_smoke.py`` counts the card's busy time from); with the
    recorder enabled it does, as a ``gpu_user_annotation``."""
    from torch.profiler import ProfilerActivity, profile

    from basicrta_torch import spans
    spans.drain()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.span("probe"):
            torch.cuda._sleep(20_000_000)       # about 10 ms
            torch.cuda.synchronize()
    (probe,) = [s for s in spans.drain() if s.name == "probe"]
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
    assert len(events) == 1, events
    start, end, _ = events[0]
    assert end - start > 1_000_000
    assert abs(start - probe.t0) < 500_000, (start - probe.t0)
    assert abs(probe.t1 - end) < 500_000, (probe.t1 - end)

    def device_events():
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            with spans.span("probe"):
                torch.cuda._sleep(1_000_000)
                torch.cuda.synchronize()
        spans.drain()
        return [e for e in prof.events() if e.device_type == cuda]

    assert len(device_events()) == 1
    spans.enable()
    try:
        annotated = device_events()
    finally:
        spans.disable()
    assert any(e.name == "probe" for e in annotated), annotated


def test_recorder_changes_no_result_on_the_card(dev):
    """``run_residues`` on engine 'cuda' with checkpoints, recorder off and
    on: the chains bitwise equal, and every sampler span recorded."""
    import tempfile

    from basicrta_torch import spans
    rng = np.random.default_rng(4)
    times = {f"R{i}": np.repeat(rng.uniform(0.1, 30.0, n),
                                rng.integers(1, 30, n))
             for i, n in enumerate((40, 300, 900))}
    cfg = GibbsConfig(ncomp=5, niter=600, g=10, seed=3)
    out = []
    for on in (False, True):
        (spans.enable if on else spans.disable)()
        with tempfile.TemporaryDirectory() as d:
            out.append(batch.run_residues(times, cfg, n_chains=2,
                                          checkpoint_dir=d, engine="cuda",
                                          segment_blocks=20))
    spans.disable()
    names = {s.name for s in spans.drain()}
    assert {"sampler.layout", "sampler.segment", "sampler.wait",
            "sampler.checkpoint"} <= names
    for name in times:
        for a, b in zip(out[0][name], out[1][name]):
            np.testing.assert_array_equal(a, b)


def test_entry_and_dryrun_on_the_card(dev):
    """``entry()`` on the card, and ``dryrun_multichip(2)`` repeating the
    card: every leg's assert passes and the fused legs launch K2 and
    K3, never a plain version."""
    from basicrta_torch import entry
    fn, args = entry.entry()
    st, W, R = fn(*args)
    assert W.device.type == "cuda" and W.shape == (8, 2, 15)
    assert torch.isfinite(W).all()
    for f in (cuda_sweep.segment, cuda_sweep.segment_packed):
        f.launches = 0
    for f in (cuda_sweep.segment_torch, cuda_sweep.segment_packed_torch):
        f.calls = 0
    entry.dryrun_multichip(2)
    assert cuda_sweep.segment.launches > 0
    assert cuda_sweep.segment_packed.launches > 0
    assert cuda_sweep.segment_torch.calls == 0
    assert cuda_sweep.segment_packed_torch.calls == 0


def test_calibrate_run_times_a_kernel_launch(dev):
    """``calibrate_layout``'s timed call launches K3 on a mixed bucket and
    K2 on a pow2 bucket and returns CUDA-event milliseconds."""
    from basicrta_torch.scripts import calibrate_layout
    rng = np.random.default_rng(6)
    times = {f"R{i}": np.repeat(np.arange(1, n) * 0.1,
                                rng.integers(1, 30, n - 1))
             for i, n in enumerate(rng.integers(20, 600, 30))}
    cfg = GibbsConfig(ncomp=15, niter=200, g=100)
    for lay in ("mixed", "pow2"):
        b = calibrate_layout._layout_batches(times, lay)[0]
        fn = cuda_sweep.segment_packed if b.pack > 1 else cuda_sweep.segment
        fn.launches = 0
        ms = calibrate_layout._make_run(b, cfg, 2, dev)()
        assert fn.launches == 1 and ms > 0
