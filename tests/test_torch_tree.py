"""The tree multinomial (K4) of basicrta_torch against the JAX package's
``tree=True`` Pallas kernels in interpret mode, draw for draw: K1's tree
form (``sweep_stats``), K2's (``segment_pallas``) and K3's packed form
(uniform pack 2 and a mixed-width bucket), at K = 4 and K = 5 (Kp = 8,
three padded nodes).

As in test_torch_sweep.py, residence times are multiples of 0.25 ns so
that every T_k sum is exact in f32 in either reduction order; a 1-ulp
difference between XLA's fused code and torch's op-by-op arithmetic may
move at most one lane onto another valid chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.sampler import pallas_sweep as jsweep
from basicrta_tpu.sampler.kernels import MixtureState as JState
from basicrta_torch.sampler import cuda_sweep
from basicrta_torch.sampler.kernels import (MixtureState, compute_tiers,
                                            dedup_times, init_mixture_params)
from test_torch_packed import _lanes_agree, _mixed_case, _uniform_case
from test_torch_sweep import _bucket, _state

B, V = 4, 384
TIERS = (1, 2)         # one row of each tier: head, small, singleton


@pytest.mark.parametrize("K", [4, 5])
def test_tree_sweep_stats_matches_jax(K):
    w, r, vals, cnts = _bucket(B, V, K, TIERS, K)
    jns, jts = jsweep.sweep_stats(
        jnp.int32(-7), JState(jnp.asarray(w), jnp.asarray(r)),
        jnp.asarray(vals), jnp.asarray(cnts), K, TIERS, interpret=True,
        tree=True)
    ns, ts = cuda_sweep.sweep_stats(-7, _state(w, r), torch.tensor(vals),
                                    torch.tensor(cnts), K, TIERS, tree=True)
    ns, ts, jns, jts = ns.numpy(), ts.numpy(), np.asarray(jns), np.asarray(jts)
    np.testing.assert_array_equal(ns.sum(1), cnts.sum(1))
    same = (ns == jns).all(1)
    assert same.sum() >= B - 1, (ns, jns)
    np.testing.assert_allclose(ts[same], jts[same], rtol=1e-5)


@pytest.mark.parametrize("K", [4, 5])
def test_tree_segment_matches_jax(K):
    w, r, vals, cnts = _bucket(B, V, K, TIERS, 10 + K)
    cfg = GibbsConfig(ncomp=K, niter=4, g=2)
    jst, jW, jR = jsweep.segment_pallas(
        jnp.int32(123456789), jnp.int32(5),
        JState(jnp.asarray(w), jnp.asarray(r)), jnp.asarray(vals),
        jnp.asarray(cnts), cfg, 2, TIERS, interpret=True, tree=True)
    st, W, R = cuda_sweep.segment(123456789, 5, _state(w, r),
                                  torch.tensor(vals), torch.tensor(cnts),
                                  cfg, 2, TIERS, tree=True)
    got = (W.numpy(), R.numpy(), st.weights.numpy(), st.rates.numpy())
    ref = tuple(np.asarray(x) for x in (jW, jR, jst.weights, jst.rates))
    assert got[0].shape == ref[0].shape == (B, 2, K)
    same = _lanes_agree(got, ref)
    assert sum(same) >= B - 1, same


def _packed_both(vals, cnts, tiers, seg_id, pack, rows, K):
    cfg = GibbsConfig(ncomp=K, niter=4, g=2)
    st0 = init_mixture_params(K)
    w = np.tile(st0.weights.numpy(), (rows, 1))
    r = np.tile(st0.rates.numpy(), (rows, 1))
    jst, jW, jR = jsweep.segment_pallas(
        jnp.int32(77), jnp.int32(3), JState(jnp.asarray(w), jnp.asarray(r)),
        jnp.asarray(vals), jnp.asarray(cnts), cfg, 2, tiers, interpret=True,
        pack=pack, tree=True,
        seg_mask=None if seg_id is None else jnp.asarray(seg_id))
    st, W, R = cuda_sweep.segment_packed(
        77, 3, MixtureState(torch.tensor(w), torch.tensor(r)),
        torch.tensor(vals), torch.tensor(cnts), cfg, 2, tiers, pack,
        None if seg_id is None else torch.tensor(seg_id), tree=True)
    return ((W.numpy(), R.numpy(), st.weights.numpy(), st.rates.numpy()),
            tuple(np.asarray(x) for x in (jW, jR, jst.weights, jst.rates)))


@pytest.mark.parametrize("K", [4, 5])
def test_tree_packed_uniform_matches_jax(K):
    vals, cnts, tiers, _ = _uniform_case(2, 3, 4, K)
    got, ref = _packed_both(vals, cnts, tiers, None, 2, 4, K)
    assert got[0].shape == ref[0].shape == (4, 2, K)
    same = _lanes_agree(got, ref)
    assert sum(same) >= 3, same


@pytest.mark.parametrize("K", [4, 5])
def test_tree_packed_mixed_matches_jax(K):
    (v, c, tiers, seg_id), slot = _mixed_case(K)
    got, ref = _packed_both(v, c, tiers, seg_id, 3, 9, K)
    same = _lanes_agree(got, ref)
    assert sum(same[i] for i in slot) >= len(slot) - 1, same


@pytest.mark.parametrize("Bn,Vn,K", [(1, 128, 15), (75, 256, 15),
                                     (300, 1024, 15), (600, 128, 5),
                                     (2, 8192, 15)])
def test_tree_group_size_matches_jax(Bn, Vn, K, monkeypatch):
    """K2's tree form budgets 3K + 12 rows a lane; the hash's lane id and
    element row follow the G that budget gives."""
    seen = {}
    layout = jsweep._group_layout

    def spy(state, values, counts, K_, rows, group_cap=None):
        seen["rows"] = rows
        out = layout(state, values, counts, K_, rows, group_cap)
        seen["G"] = out[0]
        return out

    monkeypatch.setattr(jsweep, "_group_layout", spy)
    monkeypatch.setattr(jsweep.pl, "pallas_call", lambda kernel, grid_spec,
                        out_shape, interpret: lambda *a: [
                            jnp.zeros(s.shape, s.dtype) for s in out_shape])
    jax.eval_shape(lambda: jsweep.segment_pallas.__wrapped__(
        jnp.int32(0), jnp.int32(0), JState(jnp.ones((Bn, K)),
                                           jnp.ones((Bn, K))),
        jnp.ones((Bn, Vn)), jnp.ones((Bn, Vn)), GibbsConfig(ncomp=K), 1,
        (0, 0), interpret=True, tree=True))
    assert seen["rows"] == cuda_sweep.rows_per_lane(K, True)
    assert cuda_sweep.group_size(Bn, Vn, seen["rows"]) == seen["G"]


@pytest.mark.parametrize("Bph,SL,nb,pack", [(5, 3, 100, 12), (40, 8, 100, 4),
                                             (3, 64, 7, 2)])
def test_tree_packed_group_size_matches_jax(Bph, SL, nb, pack, monkeypatch):
    B, Kn, seen = Bph * pack, 15, {}

    def spy(kernel, grid_spec, out_shape, interpret):
        seen["G"] = out_shape[2].shape[2]
        return lambda *a: [jnp.zeros(s.shape, s.dtype) for s in out_shape]

    monkeypatch.setattr(jsweep.pl, "pallas_call", spy)
    jax.eval_shape(lambda: jsweep._segment_pallas_packed(
        jnp.int32(0), jnp.int32(0),
        JState(jnp.ones((B, Kn)), jnp.ones((B, Kn))),
        jnp.ones((Bph, SL * 128)), jnp.ones((Bph, SL * 128)),
        GibbsConfig(ncomp=Kn), nb, 0, 0, True, (False,) * 4, pack,
        tree=True, seg_mask=jnp.zeros((Bph, 128))))
    assert cuda_sweep.packed_group_size(Bph, SL, Kn, nb, pack,
                                        tree=True) == seen["G"]


def test_tree_exact_resume():
    """1 + 1 blocks are bitwise 2 blocks in K2's and K3's tree forms."""
    w, r, vals, cnts = _bucket(3, 256, 5, (1, 1), 2)
    cfg = GibbsConfig(ncomp=5, niter=6, g=3)
    v, c = torch.tensor(vals), torch.tensor(cnts)
    st2, W2, R2 = cuda_sweep.segment(9, 0, _state(w, r), v, c, cfg, 2,
                                     (1, 1), tree=True)
    st1, Wa, Ra = cuda_sweep.segment(9, 0, _state(w, r), v, c, cfg, 1,
                                     (1, 1), tree=True)
    st1, Wb, Rb = cuda_sweep.segment(9, cfg.g, st1, v, c, cfg, 1, (1, 1),
                                     tree=True)
    assert torch.equal(torch.cat([Wa, Wb], 1), W2)
    assert torch.equal(torch.cat([Ra, Rb], 1), R2)
    assert torch.equal(st1.weights, st2.weights)
    (v, c, tiers, seg_id), _ = _mixed_case(3)
    st0 = init_mixture_params(5)
    st = MixtureState(st0.weights.repeat(9, 1), st0.rates.repeat(9, 1))
    args = (torch.tensor(v), torch.tensor(c))
    sid = torch.tensor(seg_id)
    s2, W2, R2 = cuda_sweep.segment_packed(9, 0, st, *args, cfg, 2, tiers, 3,
                                           sid, tree=True)
    s1, Wa, Ra = cuda_sweep.segment_packed(9, 0, st, *args, cfg, 1, tiers, 3,
                                           sid, tree=True)
    s1, Wb, Rb = cuda_sweep.segment_packed(9, cfg.g, s1, *args, cfg, 1,
                                           tiers, 3, sid, tree=True)
    assert torch.equal(torch.cat([Wa, Wb], 1), W2)
    assert torch.equal(torch.cat([Ra, Rb], 1), R2)
    assert torch.equal(s1.rates, s2.rates)


@pytest.fixture(scope="module")
def stats_case():
    """tests/test_pallas.py's moment-check bucket at a smaller size:
    3 lanes of 256 multiplicity-sorted columns of hyperexponential times."""
    rng = np.random.default_rng(31)
    Bn, Vn, K = 3, 256, 8
    vals = np.ones((Bn, Vn))
    cnts = np.zeros((Bn, Vn))
    for i in range(Bn):
        comp = rng.choice(3, size=6000, p=[0.7, 0.25, 0.05])
        x = -np.log(rng.random(6000)) / np.array([3.0, 0.3, 0.02])[comp]
        v, c = dedup_times(np.maximum(np.round(x / 0.1), 1.0) * 0.1)
        order = np.argsort(-c)
        v, c = v[order][:Vn], c[order][:Vn]
        vals[i, :len(v)] = v
        cnts[i, :len(c)] = c
    order, tiers = compute_tiers(cnts)
    vals = np.take_along_axis(vals, order, -1)
    cnts = np.take_along_axis(cnts, order, -1)
    return vals, cnts, cuda_sweep.pad_tiers_to_rows(tiers, Vn), K


@pytest.mark.parametrize("tree", [False, True])
def test_sweep_stats_exact_totals_and_moments(stats_case, tree):
    """Both forms conserve every lane's events exactly, and their mean
    N_k over 8 seeds sits within 5 sd of the multinomial's expectation
    (tests/test_pallas.py's check)."""
    vals, cnts, tiers, K = stats_case
    Bn = vals.shape[0]
    st0 = init_mixture_params(K)
    st = MixtureState(st0.weights.repeat(Bn, 1), st0.rates.repeat(Bn, 1))
    v = torch.tensor(vals, dtype=torch.float32)
    c = torch.tensor(cnts, dtype=torch.float32)
    reps, NS = 8, []
    for s in range(reps):
        ns, ts = cuda_sweep.sweep_stats(s, st, v, c, K, tiers, tree=tree)
        np.testing.assert_array_equal(ns.sum(1).numpy(), c.sum(1).numpy())
        np.testing.assert_allclose(ts.sum(1).numpy(),
                                   (vals * cnts).sum(1), rtol=1e-4)
        NS.append(ns.numpy())
    w, r = st0.weights.numpy(), st0.rates.numpy()
    z = w * r * np.exp(-np.einsum("k,bv->bvk", r, vals))
    z = z / z.sum(-1, keepdims=True)
    expect = np.einsum("bv,bvk->bk", cnts, z)
    sd = np.sqrt(np.einsum("bv,bvk->bk", cnts, z * (1 - z)) / reps)
    zscore = np.abs(np.mean(NS, 0) - expect) / np.maximum(sd, 2.0)
    assert zscore.max() < 5.0


def test_tree_wrappers_count_their_own_launches():
    """On the CPU the tree form runs its plain version: no kernel count
    moves, chain or tree."""
    w, r, vals, cnts = _bucket(2, 128, 3, (0, 1), 3)
    before = [(f.launches, f.tree_launches) for f in (
        cuda_sweep.sweep_stats, cuda_sweep.segment)]
    calls = cuda_sweep.sweep_stats_torch.calls
    cuda_sweep.sweep_stats(1, _state(w, r), torch.tensor(vals),
                           torch.tensor(cnts), 3, (0, 1), tree=True)
    assert cuda_sweep.sweep_stats_torch.calls == calls + 1
    assert before == [(f.launches, f.tree_launches) for f in (
        cuda_sweep.sweep_stats, cuda_sweep.segment)]
