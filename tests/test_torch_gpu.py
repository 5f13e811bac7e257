"""Card-only tests of the CUDA kernels: each kernel (K1, K2, the packed
K3, the PRNG probe K5) against its plain PyTorch version on the same CUDA
tensors, exact resume, the run_batch engine on packed and mixed buckets,
batched post-processing on the card, and launch refusals. They skip
without a CUDA device.

This file imports no JAX (the card's machine has none); run it there with

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

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
