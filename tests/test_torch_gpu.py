"""Card-only tests of the CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors, exact resume, the run_batch
engine, and launch refusals. They skip without a CUDA device.

This file imports no JAX (the card's machine has none); run it there with

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch, cuda_sweep
from basicrta_torch.sampler.kernels import MixtureState, init_mixture_params

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
