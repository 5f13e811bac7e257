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
