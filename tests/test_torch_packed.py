"""The packed sweep (K3, ``segment_packed``) of basicrta_torch against the
JAX package's ``segment_pallas(..., pack=p, seg_mask=...)`` in interpret
mode, draw for draw, for uniform packs 2, 4 and 8 and for mixed-width
buckets with empty slots.

As in test_torch_sweep.py, residence times are multiples of 0.25 ns so
that T_k sums are exact in f32 in either reduction order, and a 1-ulp
difference between XLA's fused code and torch's op-by-op arithmetic may
move at most one logical lane onto another valid chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.sampler import batch as jbatch
from basicrta_tpu.sampler import pallas_sweep as jsweep
from basicrta_tpu.sampler.kernels import MixtureState as JState
from basicrta_torch.sampler import batch, cuda_sweep
from basicrta_torch.sampler.kernels import MixtureState, init_mixture_params

K = 4


def _state(rows, K, seed=None):
    st = init_mixture_params(K)
    w = np.tile(st.weights.numpy(), (rows, 1))
    r = np.tile(st.rates.numpy(), (rows, 1))
    if seed is not None:
        rng = np.random.default_rng(seed)
        w = rng.dirichlet(np.ones(K), rows).astype(np.float32)
        r = rng.uniform(0.05, 3.0, (rows, K)).astype(np.float32)
    return w, r


def _member(rng, V, head, small):
    """One residue's multiplicity-sorted (values, counts), V columns:
    ``head`` counts above 16, then ``small`` counts in 2..16, then 0/1."""
    cnts = np.concatenate([rng.integers(17, 400, head),
                           rng.integers(2, 17, small),
                           rng.integers(0, 2, V - head - small)])
    vals = rng.integers(1, 121, V) * 0.25
    return vals.astype(np.float32), np.sort(cnts)[::-1].astype(np.float32)


def _uniform_case(pack, SL, B, seed):
    """Logical (B, SL * 128 // pack) lanes with one head row, one small
    row, and singleton rows below."""
    rng = np.random.default_rng(seed)
    W = 128 // pack
    members = [_member(rng, SL * W, W // 2, W) for _ in range(B)]
    vals = np.stack([m[0] for m in members])
    cnts = np.stack([m[1] for m in members])
    tiers = jsweep.packed_row_tiers(
        (int((cnts > 16).sum(1).max()), int((cnts > 1).sum(1).max())), W,
        SL)
    return vals, cnts, tiers, None


def _mixed_case(seed):
    """Three physical lanes of SL = 3 rows: a 3-member lane, a lane with
    one member and two empty slots, a 2-member lane; some columns belong
    to no member."""
    rng = np.random.default_rng(seed)
    widths = np.array([[50, 40, 30], [100, 0, 0], [64, 60, 0]], np.int64)
    SL = 3
    members = []
    for w in widths[widths > 0]:
        V = int(rng.integers(SL * w - w + 1, SL * w + 1))
        members.append(_member(rng, V, int(w) // 3, int(w)))
    Vm = max(len(v) for v, _ in members)
    vals = np.ones((len(members), Vm), np.float32)
    cnts = np.zeros((len(members), Vm), np.float32)
    for i, (v, c) in enumerate(members):
        vals[i, :len(v)], cnts[i, :len(c)] = v, c
    v_ph, c_ph, seg_id, slot = batch._pack_mixed(vals, cnts, widths, SL)
    return (v_ph.reshape(3, -1), c_ph.reshape(3, -1),
            batch._mixed_row_tiers(c_ph), seg_id), slot


def _run_both(vals, cnts, tiers, seg_id, pack, state, cfg, nb, seed=77,
              offset=3):
    w, r = state
    jst, jW, jR = jsweep.segment_pallas(
        jnp.int32(seed), jnp.int32(offset), JState(jnp.asarray(w),
                                                   jnp.asarray(r)),
        jnp.asarray(vals), jnp.asarray(cnts), GibbsConfig(**cfg), nb, tiers,
        interpret=True, pack=pack,
        seg_mask=None if seg_id is None else jnp.asarray(seg_id))
    st, W, R = cuda_sweep.segment_packed(
        seed, offset, MixtureState(torch.tensor(w), torch.tensor(r)),
        torch.tensor(vals), torch.tensor(cnts), GibbsConfig(**cfg), nb,
        tiers, pack, None if seg_id is None else torch.tensor(seg_id))
    return ((W.numpy(), R.numpy(), st.weights.numpy(), st.rates.numpy()),
            (np.asarray(jW), np.asarray(jR), np.asarray(jst.weights),
             np.asarray(jst.rates)))


def _lanes_agree(got, ref):
    return [all(np.allclose(a[b], e[b], rtol=1e-4) for a, e in zip(got, ref))
            for b in range(ref[0].shape[0])]


CASES = {"p2": (2, 3, 4), "p4": (4, 2, 8), "p8": (8, 4, 8)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_uniform_packed_matches_jax(name):
    pack, SL, B = CASES[name]
    vals, cnts, tiers, _ = _uniform_case(pack, SL, B, pack)
    cfg = dict(ncomp=K, niter=4, g=2)
    got, ref = _run_both(vals, cnts, tiers, None, pack, _state(B, K), cfg, 2)
    assert got[0].shape == ref[0].shape == (B, 2, K)
    same = _lanes_agree(got, ref)
    assert sum(same) >= B - 1, same


def test_mixed_packed_matches_jax():
    (v, c, tiers, seg_id), slot = _mixed_case(1)
    rows = 3 * 3
    cfg = dict(ncomp=K, niter=4, g=2)
    got, ref = _run_both(v, c, tiers, seg_id, 3, _state(rows, K), cfg, 2)
    assert got[0].shape == ref[0].shape == (rows, 2, K)
    same = _lanes_agree(got, ref)
    assert sum(same[i] for i in slot) >= len(slot) - 1, same


def _port_stats(v, c, seg_id, pack, tiers, w, r, G, seed):
    """The port's per-slot (N_k, T_k) of one sweep, (Bph, pack, K)."""
    vt, ct, sid = torch.tensor(v), torch.tensor(c), torch.tensor(seg_id)
    Bph, V = vt.shape
    lay = cuda_sweep._Layout(Bph, V, K, tiers, G, vt.device, pack)
    masks = (sid.long()[:, None, :] == torch.arange(pack)[None, :, None]
             ).float()
    col = sid.long().repeat(1, V // 128)[:, None, :].expand(Bph, K, V)
    w_col = torch.gather(torch.tensor(w).reshape(Bph, pack, K).transpose(
        1, 2), 2, col)
    r_col = torch.gather(torch.tensor(r).reshape(Bph, pack, K).transpose(
        1, 2), 2, col)
    ns, ts = cuda_sweep._suff_stats(cuda_sweep._Rng(seed, lay.lane), lay,
                                    vt, ct, w_col, r_col, K, True,
                                    cuda_sweep._slot_sums(masks))
    return ns.numpy(), ts.numpy()


def test_packed_stats_match_jax_exactly():
    """One sweep's per-slot statistics against the JAX packed body run
    eagerly on one lane group: N_k identical, T_k to rounding."""
    (v, c, tiers, seg_id), slot = _mixed_case(2)
    pack, Bph, G, seed = 3, 3, 8, 12345
    SL = v.shape[1] // 128
    w, r = _state(pack * Bph, K, seed=4)
    ns, ts = _port_stats(v, c, seg_id, pack, tiers, w, r, G, seed)

    def tile(x, fill):          # (Bph, SL*128) -> (SL, G, 128), padded
        out = np.full((G, SL, 128), fill, np.float32)
        out[:Bph] = x.reshape(Bph, SL, 128)
        return jnp.asarray(out.transpose(1, 0, 2))

    def pgk(x):                 # (pack*Bph, K) -> (pack, G, K), padded
        out = np.ones((G, pack, K), np.float32)
        out[:Bph] = x.reshape(Bph, pack, K)
        return jnp.asarray(out.transpose(1, 0, 2))

    sid = np.zeros((G, 128), np.float32)
    sid[:Bph] = seg_id
    masks = [jnp.asarray((sid == s).astype(np.float32)) for s in range(pack)]
    jns, jts = jsweep._suff_stats_packed(
        jsweep._Rng(True, seed, 0), tile(v, 1.0), tile(c, 0.0), pgk(w),
        pgk(r), [None] * K, K, tiers[0], tiers[1], pack,
        (False, "btrd_nat_h4", False, True), masks)
    jns = np.asarray(jns).transpose(1, 0, 2)[:Bph]
    jts = np.asarray(jts).transpose(1, 0, 2)[:Bph]
    np.testing.assert_array_equal(ns, jns)
    np.testing.assert_allclose(ts, jts, rtol=1e-5)
    # the slots' statistics conserve each member's events
    np.testing.assert_array_equal(
        ns.sum(-1), np.stack([(c.reshape(Bph, SL, 128).sum(1)
                               * (seg_id == s)).sum(-1)
                              for s in range(pack)], 1))


def test_packed_exact_resume():
    """1 + 1 blocks are bitwise 2 blocks, mixed and uniform."""
    (v, c, tiers, seg_id), _ = _mixed_case(3)
    for vals, cnts, tiers, sid, pack, rows in (
            (v, c, tiers, seg_id, 3, 9),
            _uniform_case(2, 2, 4, 5) + (2, 4)):
        cfg = GibbsConfig(ncomp=K, niter=6, g=3)
        w, r = _state(rows, K)
        st = MixtureState(torch.tensor(w), torch.tensor(r))
        vt, ct = torch.tensor(vals), torch.tensor(cnts)
        mt = None if sid is None else torch.tensor(sid)
        s2, W2, R2 = cuda_sweep.segment_packed(9, 0, st, vt, ct, cfg, 2,
                                               tiers, pack, mt)
        s1, Wa, Ra = cuda_sweep.segment_packed(9, 0, st, vt, ct, cfg, 1,
                                               tiers, pack, mt)
        s1, Wb, Rb = cuda_sweep.segment_packed(9, cfg.g, s1, vt, ct, cfg, 1,
                                               tiers, pack, mt)
        assert torch.equal(torch.cat([Wa, Wb], 1), W2)
        assert torch.equal(torch.cat([Ra, Rb], 1), R2)
        assert torch.equal(s1.weights, s2.weights)
        assert torch.equal(s1.rates, s2.rates)


def test_empty_slots_are_isolated():
    """An empty slot owns no columns: whatever its state, the members'
    chains are unchanged, and it draws from the prior alone."""
    (v, c, tiers, seg_id), slot = _mixed_case(4)
    cfg = GibbsConfig(ncomp=K, niter=4, g=2)
    w, r = _state(9, K)
    empty = np.setdiff1d(np.arange(9), slot)
    assert len(empty) == 3
    w2, r2 = w.copy(), r.copy()
    w2[empty] = 0.5
    r2[empty] = 1e3
    out = []
    for ww, rr in ((w, r), (w2, r2)):
        out.append(cuda_sweep.segment_packed(
            4, 0, MixtureState(torch.tensor(ww), torch.tensor(rr)),
            torch.tensor(v), torch.tensor(c), cfg, 2, tiers, 3,
            torch.tensor(seg_id)))
    for a, b in zip(out[0][1:], out[1][1:]):
        assert torch.equal(a[slot], b[slot])
    assert torch.isfinite(out[0][1][empty]).all()


@pytest.mark.parametrize("Bph,SL,nb,pack", [(5, 3, 100, 12), (40, 8, 100, 4),
                                             (200, 2, 1, 8), (3, 64, 7, 2),
                                             (130, 6, 100, 2)])
def test_packed_group_size_matches_jax(Bph, SL, nb, pack, monkeypatch):
    """K3's G counts the thinned outputs: the hash lane id and element row
    need the reference's packed formula, not K2's."""
    import jax
    B, Kn, seen = Bph * pack, 15, {}

    def spy(kernel, grid_spec, out_shape, interpret):
        # the reference's G, read off its (NG, pack, G, K) final state
        seen["G"] = out_shape[2].shape[2]
        return lambda *a: [jnp.zeros(s.shape, s.dtype) for s in out_shape]

    monkeypatch.setattr(jsweep.pl, "pallas_call", spy)
    jax.eval_shape(lambda: jsweep._segment_pallas_packed(
        jnp.int32(0), jnp.int32(0),
        JState(jnp.ones((B, Kn)), jnp.ones((B, Kn))),
        jnp.ones((Bph, SL * 128)), jnp.ones((Bph, SL * 128)),
        GibbsConfig(ncomp=Kn), nb, 0, 0, True, (False,) * 4, pack,
        seg_mask=jnp.zeros((Bph, 128))))
    assert cuda_sweep.packed_group_size(Bph, SL, Kn, nb, pack) == seen["G"]


@pytest.mark.parametrize("tiers,W,SL", [((0, 0), 64, 3), ((10, 70), 64, 3),
                                        ((33, 33), 16, 4), ((200, 300), 32, 5)])
def test_packed_row_tiers(tiers, W, SL):
    assert (cuda_sweep.packed_row_tiers(tiers, W, SL)
            == jsweep.packed_row_tiers(tiers, W, SL))


def test_packed_malformed_inputs_raise():
    vals, cnts, tiers, _ = _uniform_case(2, 2, 4, 6)
    w, r = _state(4, K)
    st = MixtureState(torch.tensor(w), torch.tensor(r))
    cfg = GibbsConfig(ncomp=K, niter=1, g=1)
    with pytest.raises(ValueError, match="B % pack"):
        cuda_sweep.segment_packed(0, 0, st, torch.tensor(vals[:3]),
                                  torch.tensor(cnts[:3]), cfg, 1, tiers, 2)
    with pytest.raises(ValueError, match="pack must"):
        cuda_sweep.segment_packed(0, 0, st, torch.tensor(vals),
                                  torch.tensor(cnts), cfg, 1, tiers, 1)
    with pytest.raises(ValueError, match="slot ids"):
        cuda_sweep.segment_packed(
            0, 0, MixtureState(torch.ones(6, K), torch.ones(6, K)),
            torch.ones(2, 256), torch.zeros(2, 256), cfg, 1, (0, 0), 3,
            torch.full((2, 128), 3.0))
    with pytest.raises(ValueError, match="state must be"):
        cuda_sweep.segment_packed(
            0, 0, st, torch.ones(2, 256), torch.zeros(2, 256), cfg, 1,
            (0, 0), 3, torch.zeros((2, 128)))


def test_pack_mixed_round_trip_equals_jax():
    """The port's host packing equals the JAX package's, and unpacking the
    physical rows through the slot widths gives every member back."""
    rng = np.random.default_rng(8)
    widths = np.array([[30, 50, 0, 0], [20, 20, 20, 20], [128, 0, 0, 0]],
                      np.int64)
    SL = 2
    n = int((widths > 0).sum())
    vals = np.ones((n, 2 * 128), np.float32)
    cnts = np.zeros((n, 2 * 128), np.float32)
    for i, w in enumerate(widths[widths > 0]):
        V = int(rng.integers(1, SL * w + 1))
        vals[i, :V], cnts[i, :V] = _member(rng, V, 0, 0)
        cnts[i, :V] += 1
    got = batch._pack_mixed(vals, cnts, widths, SL)
    ref = jbatch._pack_mixed(vals, cnts, widths, SL)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    v_ph, c_ph, seg_id, slot = got
    i = 0
    for g in range(3):
        off = 0
        for s in range(4):
            w = int(widths[g, s])
            if w == 0:
                continue
            assert slot[i] == g * 4 + s
            back = c_ph[g, :, off:off + w].reshape(-1)
            np.testing.assert_array_equal(back, cnts[i, :SL * w])
            assert not cnts[i, SL * w:].any()
            assert (seg_id[g, off:off + w] == s).all()
            off += w
            i += 1
    with pytest.raises(ValueError, match="overflow"):
        batch._pack_mixed(vals, cnts + 1, widths, SL)
    with pytest.raises(ValueError, match="underflow"):
        batch._pack_mixed(vals[:-1], cnts[:-1], widths, SL)
