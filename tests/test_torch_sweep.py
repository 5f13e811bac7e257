"""The fused sweep (K1 sweep_stats, K2 segment) of basicrta_torch against
the JAX package's Pallas kernels in interpret mode, draw for draw.

Both packages draw from the same counter hash with the same call sites
and element ids, so the plain PyTorch versions reproduce the interpret
path's draws. Residence times here are multiples of 0.25 ns so that every
T_k sum is exact in f32 and the two reduction orders cannot differ. What
remains are 1-ulp differences between XLA's fused code and torch's
op-by-op arithmetic; where one flips an inversion step or a gamma draw,
that lane continues on another, equally valid chain. Such flips are rare,
and the inputs are fixed, so each check allows at most one lane to leave.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.sampler import pallas_sweep as jsweep
from basicrta_tpu.sampler.kernels import MixtureState as JState
from basicrta_torch.sampler import cuda_sweep
from basicrta_torch.sampler.kernels import MixtureState, init_mixture_params

B, V, K = 4, 384, 4
TIERS = (1, 2)         # one row of each tier: head, small, singleton


def _bucket(B, V, K, tiers, seed):
    rng = np.random.default_rng(seed)
    h, s = tiers
    vals = (rng.integers(1, 121, (B, V)) * 0.25).astype(np.float32)
    cnts = np.concatenate([rng.integers(17, 400, (B, 128 * h)),
                           rng.integers(2, 17, (B, 128 * (s - h))),
                           rng.integers(0, 2, (B, V - 128 * s))],
                          1).astype(np.float32)
    st = init_mixture_params(K)
    w = np.tile(st.weights.numpy(), (B, 1))
    r = np.tile(st.rates.numpy(), (B, 1))
    return w, r, vals, cnts


def _state(w, r, device="cpu"):
    return MixtureState(torch.tensor(w, device=device),
                        torch.tensor(r, device=device))


@pytest.fixture(scope="module")
def case():
    """Inputs and the JAX interpret-mode K1 and K2 outputs, once."""
    w, r, vals, cnts = _bucket(B, V, K, TIERS, 0)
    jst = JState(jnp.asarray(w), jnp.asarray(r))
    ns, ts = jsweep.sweep_stats(jnp.int32(-7), jst, jnp.asarray(vals),
                                jnp.asarray(cnts), K, TIERS, interpret=True)
    cfg = GibbsConfig(ncomp=K, niter=10, g=5)
    st, W, R = jsweep.segment_pallas(jnp.int32(123456789), jnp.int32(5), jst,
                                     jnp.asarray(vals), jnp.asarray(cnts),
                                     cfg, 2, TIERS, interpret=True)
    return dict(w=w, r=r, vals=vals, cnts=cnts, cfg=cfg,
                ns=np.asarray(ns), ts=np.asarray(ts), W=np.asarray(W),
                R=np.asarray(R), wf=np.asarray(st.weights),
                rf=np.asarray(st.rates))


def test_sweep_stats_matches_jax(case):
    ns, ts = cuda_sweep.sweep_stats_torch(
        -7, _state(case["w"], case["r"]), torch.tensor(case["vals"]),
        torch.tensor(case["cnts"]), K, TIERS)
    ns, ts = ns.numpy(), ts.numpy()
    np.testing.assert_array_equal(ns.sum(1), case["cnts"].sum(1))
    lane_same = (ns == case["ns"]).all(1)
    assert lane_same.sum() >= B - 1
    np.testing.assert_allclose(ts[lane_same], case["ts"][lane_same],
                               rtol=1e-5)


def test_segment_matches_jax(case):
    st, W, R = cuda_sweep.segment_torch(
        123456789, 5, _state(case["w"], case["r"]),
        torch.tensor(case["vals"]), torch.tensor(case["cnts"]), case["cfg"],
        2, TIERS)
    W, R = W.numpy(), R.numpy()
    assert W.shape == case["W"].shape == (B, 2, K)
    same = [np.allclose(W[b], case["W"][b], rtol=1e-4)
            and np.allclose(R[b], case["R"][b], rtol=1e-4)
            and np.allclose(st.weights[b].numpy(), case["wf"][b], rtol=1e-4)
            for b in range(B)]
    assert sum(same) >= B - 1, same


@pytest.mark.parametrize("tiers", [(0, 0), (0, 1), (1, 1), (2, 2)])
def test_sweep_stats_conserves_counts(tiers):
    """Every tier layout (incl. empty tiers, which shift the call sites)
    conserves each lane's event count exactly."""
    w, r, vals, cnts = _bucket(3, 256, 5, tiers, 1)
    ns, ts = cuda_sweep.sweep_stats(3, _state(w, r), torch.tensor(vals),
                                    torch.tensor(cnts), 5, tiers)
    np.testing.assert_array_equal(ns.sum(1).numpy(), cnts.sum(1))
    np.testing.assert_allclose(ts.sum(1).numpy(), (vals * cnts).sum(1),
                               rtol=1e-6)


def test_segment_exact_resume():
    """Per-sweep reseeding: 2 segments of 1 block are bitwise 1 segment of
    2 blocks (cf. tests/test_aux.py pallas resume)."""
    w, r, vals, cnts = _bucket(3, 256, 4, (1, 1), 2)
    cfg = GibbsConfig(ncomp=4, niter=6, g=3)
    v, c = torch.tensor(vals), torch.tensor(cnts)
    st2, W2, R2 = cuda_sweep.segment(9, 0, _state(w, r), v, c, cfg, 2, (1, 1))
    st1, Wa, Ra = cuda_sweep.segment(9, 0, _state(w, r), v, c, cfg, 1, (1, 1))
    st1, Wb, Rb = cuda_sweep.segment(9, cfg.g, st1, v, c, cfg, 1, (1, 1))
    assert torch.equal(torch.cat([Wa, Wb], 1), W2)
    assert torch.equal(torch.cat([Ra, Rb], 1), R2)
    assert torch.equal(st1.weights, st2.weights)
    assert torch.equal(st1.rates, st2.rates)


def test_cpu_wrappers_run_the_plain_versions():
    w, r, vals, cnts = _bucket(2, 128, 3, (0, 1), 3)
    v, c = torch.tensor(vals), torch.tensor(cnts)
    launches = (cuda_sweep.sweep_stats.launches, cuda_sweep.segment.launches)
    calls = cuda_sweep.sweep_stats_torch.calls
    a = cuda_sweep.sweep_stats(1, _state(w, r), v, c, 3, (0, 1))
    b = cuda_sweep.sweep_stats_torch(1, _state(w, r), v, c, 3, (0, 1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cuda_sweep.sweep_stats_torch.calls == calls + 2
    cfg = GibbsConfig(ncomp=3, niter=2, g=1)
    cuda_sweep.segment(1, 0, _state(w, r), v, c, cfg, 2, (0, 1))
    assert (cuda_sweep.sweep_stats.launches,
            cuda_sweep.segment.launches) == launches


@pytest.mark.parametrize("Bn,Vn,rows", [(1, 128, 7), (4, 384, 16),
                                        (75, 256, 27), (300, 1024, 27),
                                        (600, 128, 18), (2, 8192, 27)])
def test_group_size_matches_jax_layout(Bn, Vn, rows):
    """The hash's lane id b // G and element row b % G need the
    reference layout's group size G."""
    st = JState(jnp.ones((Bn, 2)), jnp.ones((Bn, 2)))
    G = jsweep._group_layout(st, jnp.ones((Bn, Vn)), jnp.ones((Bn, Vn)), 2,
                             rows)[0]
    assert cuda_sweep.group_size(Bn, Vn, rows) == G


@pytest.mark.parametrize("tiers,Vn", [((0, 0), 512), ((1, 130), 512),
                                      ((128, 128), 512), ((513, 600), 512),
                                      ((40, 300), 1024)])
def test_pad_tiers_to_rows(tiers, Vn):
    assert (cuda_sweep.pad_tiers_to_rows(tiers, Vn)
            == jsweep.pad_tiers_to_rows(tiers, Vn))


def test_malformed_inputs_raise():
    w, r, vals, cnts = _bucket(2, 128, 3, (0, 1), 4)
    st = _state(w, r)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_sweep.sweep_stats(0, st, torch.tensor(vals[:, :100]),
                               torch.tensor(cnts[:, :100]), 3, (0, 0))
    with pytest.raises(ValueError, match="float32"):
        cuda_sweep.sweep_stats(0, st, torch.tensor(vals, dtype=torch.float64),
                               torch.tensor(cnts), 3, (0, 1))
    with pytest.raises(ValueError, match="row tiers"):
        cuda_sweep.sweep_stats(0, st, torch.tensor(vals), torch.tensor(cnts),
                               3, (1, 0))


@pytest.mark.parametrize("ncomp", [3, 15])
def test_chain_helpers_match_jax(ncomp):
    from basicrta_tpu.sampler import kernels as jk
    from basicrta_torch.sampler import kernels as tk
    a, b = tk.init_mixture_params(ncomp), jk.init_mixture_params(ncomp)
    np.testing.assert_array_equal(a.weights.numpy(), np.asarray(b.weights))
    np.testing.assert_array_equal(a.rates.numpy(), np.asarray(b.rates))
    t = np.random.default_rng(ncomp).integers(1, 300, 5000) * 0.1
    for x, y in zip(tk.dedup_times(t), jk.dedup_times(t)):
        np.testing.assert_array_equal(x, y)
    counts = np.random.default_rng(ncomp).integers(0, 40, (3, 200))
    (o1, t1), (o2, t2) = tk.compute_tiers(counts), jk.compute_tiers(counts)
    np.testing.assert_array_equal(o1, o2)
    assert t1 == t2
