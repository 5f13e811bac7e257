"""The port's contacts path against the JAX package's, on the CPU.

The same inputs (numpy, from a seed) go through ``basicrta_tpu.contacts``
and ``basicrta_torch.contacts`` (``device="cpu"``). Tolerances:

- contact rows: identical (frame, sel1, sel2) rows, except pairs whose
  distance lies within 1e-4 A of the cutoff (XLA fuses and may contract
  where eager torch rounds every op; a pair within an ulp of the cutoff may
  flip);
- ``min_dist``: atol 1e-4 A; under the u16 wire format both packages
  quantize bit for bit alike, so the same bound holds between them, and
  against the unquantized host reference the format's bound (sqrt(3) grid
  steps of extent/65535) comes on top;
- frames, times, ``ts``, event tables, the quantizer: exact.

``torch.topk`` and ``jax.lax.top_k`` order ties differently, so compacted
buffers are compared as row sets and counts, never slot by slot.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from basicrta_tpu.config import ContactConfig as JConfig
from basicrta_tpu.contacts import distances as jd
from basicrta_tpu.contacts import mapper as jm
from basicrta_tpu.contacts.events import merge_events as j_merge
from basicrta_tpu.contacts.quantize import quantize_u16 as j_quantize
from basicrta_tpu.contacts.records import ContactMeta as JMeta
from basicrta_tpu.contacts.records import ContactRecords as JRecords

from basicrta_torch.config import ContactConfig
from basicrta_torch.contacts import distances as td
from basicrta_torch.contacts import mapper as tm
from basicrta_torch.contacts.events import merge_events
from basicrta_torch.contacts.quantize import quantize_u16
from basicrta_torch.contacts.records import (ContactMeta, ContactRecords,
                                             FrameBatch)
from basicrta_torch.scripts import contacts_reference as ref

ATOL = 1e-4          # A, min_dist
EDGE = 1e-4          # A, rows this close to the cutoff may flip


def _rows(rec):
    return {(int(f), int(a), int(b)): float(d) for f, a, b, d in
            zip(rec.frames, rec.sel1_resids, rec.sel2_resids, rec.min_dist)}


def assert_records_match(got, want, cutoff, atol=ATOL):
    """The stated tolerance: equal rows except within EDGE of the cutoff,
    min_dist within atol, times and ts exact."""
    g, w = _rows(got), _rows(want)
    for k in g.keys() ^ w.keys():
        d = g.get(k, w.get(k))
        assert abs(d - cutoff) <= EDGE, (k, d)
    shared = g.keys() & w.keys()
    assert len(shared) > 0
    assert max(abs(g[k] - w[k]) for k in shared) <= atol
    assert got.meta.ts == want.meta.ts
    assert got.meta.cutoff == want.meta.cutoff
    if g.keys() == w.keys():
        np.testing.assert_array_equal(got.frames, want.frames)
        np.testing.assert_array_equal(got.sel1_resids, want.sel1_resids)
        np.testing.assert_array_equal(got.sel2_resids, want.sel2_resids)
        np.testing.assert_array_equal(got.times, want.times)
    assert got.frames.dtype == want.frames.dtype
    assert got.min_dist.dtype == want.min_dist.dtype
    assert got.times.dtype == want.times.dtype


def _system(rng, F=6, R1=8, P1=5, R2=6, P2=4, spread=24.0, sigma=1.0):
    resids1 = np.repeat(np.arange(R1), P1)
    resids2 = np.repeat(np.arange(R2) + 100, P2)
    c1 = rng.uniform(0, spread, (F, R1, 3))
    c2 = rng.uniform(0, spread, (F, R2, 3))
    pos1 = (c1[:, :, None] + rng.normal(0, sigma, (F, R1, P1, 3)))
    pos2 = (c2[:, :, None] + rng.normal(0, sigma, (F, R2, P2, 3)))
    pos = np.concatenate([pos1.reshape(F, -1, 3), pos2.reshape(F, -1, 3)],
                         axis=1).astype(np.float32)
    return pos, resids1, resids2, R1 * P1


def _ragged(rng, F=3):
    """Residues of unequal size: the padded slots and their masks."""
    A1, A2 = 17, 23
    pos = rng.uniform(0, 30, (F, A1 + A2, 3)).astype(np.float32)
    resids1 = np.repeat(np.arange(4), [5, 4, 5, 3])
    resids2 = np.repeat(np.arange(5) + 100, [5, 5, 5, 5, 3])
    return pos, resids1, resids2, A1


def _grouped(pos, resids1, resids2, A1):
    i1, _ = td.group_by_residue(resids1)
    i2, _ = td.group_by_residue(resids2)
    j1, jm1 = jd.gather_grouped(jnp.asarray(pos[:, :A1]), i1)
    j2, jm2 = jd.gather_grouped(jnp.asarray(pos[:, A1:]), i2)
    t1, tm1 = td.gather_grouped(torch.from_numpy(pos[:, :A1]), i1)
    t2, tm2 = td.gather_grouped(torch.from_numpy(pos[:, A1:]), i2)
    return (j1, j2, jm1, jm2), (t1, t2, tm1, tm2)


_H = np.array([[22.0, 0, 0], [8.0, 24.0, 0], [-6.0, 7.0, 26.0]], np.float32)


def _box(kind, F):
    if kind == "ortho":
        return np.tile(np.array([25.0, 28.0, 30.0], np.float32), (F, 1))
    if kind == "triclinic":
        return np.tile(_H, (F, 1, 1))
    return None


@pytest.mark.parametrize("resids", [[3, 3, 1, 7, 1, 3, 9], [5] * 4,
                                    list(range(6))])
def test_group_by_residue_equals_jax(resids):
    a, ua = td.group_by_residue(np.array(resids))
    b, ub = jd.group_by_residue(np.array(resids))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ua, ub)


@pytest.mark.parametrize("kind", ["ortho", "none", "triclinic"])
def test_dense_kernel_matches_jax_with_masks(rng, kind):
    pos, r1, r2, A1 = _ragged(rng)
    box = _box(kind, len(pos))
    (j1, j2, jm1, jm2), (t1, t2, tm1, tm2) = _grouped(pos, r1, r2, A1)
    kw = dict(use_pbc=box is not None, triclinic=kind == "triclinic")
    want = np.asarray(jd.min_dist_per_residue_pair(
        j1, j2, None if box is None else jnp.asarray(box), chunk=3,
        mask1=jm1, mask2=jm2, **kw))
    tb = None if box is None else torch.from_numpy(box)
    got = td.min_dist_per_residue_pair(t1, t2, tb, mask1=tm1, mask2=tm2,
                                       **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the chunk is not part of the result: two chunk sizes, bit for bit
    for chunk in (1, 3):
        again = td.min_dist_per_residue_pair(t1, t2, tb, chunk=chunk,
                                             mask1=tm1, mask2=tm2, **kw)
        assert torch.equal(again, got)


def test_dense_kernel_without_masks_and_min_image(rng):
    pos1 = rng.uniform(0, 5, (1, 1, 1, 3)).astype(np.float32)
    pos2 = pos1 + np.array([19.0, 0, 0], np.float32)
    d_pbc = td.min_dist_per_residue_pair(
        torch.from_numpy(pos1), torch.from_numpy(pos2),
        torch.full((1, 3), 20.0))
    d_free = td.min_dist_per_residue_pair(
        torch.from_numpy(pos1), torch.from_numpy(pos2), use_pbc=False)
    assert d_pbc[0, 0, 0].item() == pytest.approx(1.0, abs=1e-3)
    assert d_free[0, 0, 0].item() == pytest.approx(19.0, abs=1e-3)


def test_triclinic_agrees_with_host_reference(rng):
    pos, r1, r2, A1 = _system(rng, F=2, spread=18.0)
    _, (t1, t2, _, _) = _grouped(pos, r1, r2, A1)
    got = td.min_dist_per_residue_pair(
        t1, t2, torch.from_numpy(_box("triclinic", 2)), triclinic=True)
    for f in range(2):
        a, b, d = ref.frame_contacts(pos[f], _H, np.arange(A1), r1,
                                     np.arange(A1, pos.shape[1]), r2, 7.0)
        assert len(d) > 0
        np.testing.assert_allclose(got[f, a, b - 100].numpy(), d, atol=ATOL)


def _compact_rows(n, idx, dist, cutoff):
    n, idx, dist = (np.asarray(x) for x in (n, idx, dist))
    out = {}
    for f, k in zip(*np.nonzero(dist <= cutoff)):
        out[(int(f), int(idx[f, k]))] = float(dist[f, k])
    return n, out


def test_compact_contacts_row_sets_equal_jax(rng):
    dmin = rng.uniform(0.0, 30.0, (4, 20, 30)).astype(np.float32)
    nj, rj = _compact_rows(*jd.compact_contacts(jnp.asarray(dmin), 10.0,
                                                512), 10.0)
    n, idx, dist = td.compact_contacts(torch.from_numpy(dmin), 10.0, 512)
    assert n.dtype == torch.int32 and idx.dtype == torch.int32
    assert dist.dtype == torch.float32 and dist.shape == (4, 512)
    nt, rt = _compact_rows(n, idx, dist, 10.0)
    np.testing.assert_array_equal(nt, nj)
    assert rt == rj                      # exact f32 values survive topk
    assert np.isinf(dist.numpy()).sum() == dist.numel() - nt.sum()


def test_compact_contacts_overflow_detected():
    dmin = torch.full((2, 4, 4), 1.0)
    n, idx, dist = td.compact_contacts(dmin, 5.0, 8)
    assert (n == 16).all() and (n > dist.shape[1]).all()


@pytest.mark.parametrize("kind", ["ortho", "none", "triclinic"])
def test_pruned_kernel_row_sets_equal_jax(rng, kind):
    pos, r1, r2, A1 = _system(rng, F=4, spread=18.0 if kind == "triclinic"
                              else 24.0)
    pos[:, 3] += 2.0                     # a ragged residue: one atom far off
    box = _box(kind, 4)
    (j1, j2, jm1, jm2), (t1, t2, tm1, tm2) = _grouped(pos, r1, r2, A1)
    kw = dict(use_pbc=box is not None, triclinic=kind == "triclinic")
    cutoff = 8.0
    nj, rj = _compact_rows(*jd.min_dist_pruned(
        j1, j2, cutoff, None if box is None else jnp.asarray(box),
        cap_pairs=64, chunk=16, mask1=jm1, mask2=jm2, **kw), cutoff)
    tb = None if box is None else torch.from_numpy(box)
    out = td.min_dist_pruned(t1, t2, cutoff, tb, cap_pairs=64, mask1=tm1,
                             mask2=tm2, **kw)
    nt, rt = _compact_rows(*out, cutoff)
    np.testing.assert_array_equal(nt, nj)
    assert rt.keys() == rj.keys() and len(rt) > 0
    assert max(abs(rt[k] - rj[k]) for k in rt) <= ATOL
    # the pair chunk is not part of the result either
    for chunk in (5, 64):
        again = td.min_dist_pruned(t1, t2, cutoff, tb, cap_pairs=64,
                                   chunk=chunk, mask1=tm1, mask2=tm2, **kw)
        assert _compact_rows(*again, cutoff)[1] == rt
    # every dense sub-cutoff pair is among the pruned ones
    dense = td.min_dist_per_residue_pair(t1, t2, tb, mask1=tm1, mask2=tm2,
                                         **kw).numpy()
    R2 = dense.shape[2]
    for f, i, j in zip(*np.nonzero(dense <= cutoff)):
        assert rt[(f, i * R2 + j)] == dense[f, i, j]


def test_pruned_kernel_overflow_detected(rng):
    pos, r1, r2, A1 = _system(rng, F=2, spread=6.0)
    _, (t1, t2, _, _) = _grouped(pos, r1, r2, A1)
    n, idx, dist = td.min_dist_pruned(t1, t2, 10.0, cap_pairs=4,
                                      use_pbc=False)
    assert (n > 4).all() and dist.shape == (2, 4)


@pytest.mark.parametrize("offset", [0.0, 5000.0])
def test_quantize_u16_bitwise(rng, offset):
    pos = (rng.uniform(-20, 140, (3, 50, 3)) + offset).astype(np.float32)
    pos[0, 0] = pos[0].min(0)
    q, s = quantize_u16(pos.copy())
    qj, sj = j_quantize(pos.copy())
    assert q.dtype == np.uint16 and s.dtype == np.float32
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)


@pytest.mark.parametrize("ts", [0.1, 1.0, 0.25])
def test_merge_events_exact(rng, ts):
    n = 400
    frames = rng.integers(0, 60, n)
    s1 = rng.integers(1, 4, n).astype(np.int32)
    s2 = rng.integers(100, 103, n).astype(np.int32)
    key = np.unique(np.stack([frames, s1, s2], 1), axis=0)
    frames, s1, s2 = key[:, 0], key[:, 1].astype(np.int32), \
        key[:, 2].astype(np.int32)
    dist = rng.uniform(2, 10, len(key)).astype(np.float32)
    args = (frames.astype(np.int64), s1, s2, dist, frames * ts)
    a = merge_events(ContactRecords(*args, ContactMeta(ts=ts, cutoff=10.0)),
                     7.0)
    b = j_merge(JRecords(*args, JMeta(ts=ts, cutoff=10.0)), 7.0)
    assert len(a) == len(b) > 0
    for f in ("sel1_resids", "sel2_resids", "start_times", "durations"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.meta.to_dict() == b.meta.to_dict()


# ---------------------------------------------------------------- mapper

def _batches(cls, pos, box, ts=0.1, size=4, start=0):
    out = []
    for lo in range(0, len(pos), size):
        ids = np.arange(lo, min(lo + size, len(pos))) + start
        out.append(cls(ids, ids * ts, pos[lo:lo + size],
                       None if box is None else box[lo:lo + size]))
    return out


def _both(pos, r1, r2, A1, box, size=4, idx=None, meta_ts=None, **cfg):
    """The same scan through both packages; returns (torch records, JAX
    records, the port's mapper)."""
    idx1, idx2 = idx or (np.arange(A1), np.arange(A1, pos.shape[1]))
    mj = jm.MapContacts(idx1, r1, idx2, r2, cfg=JConfig(**cfg),
                        meta=JMeta(ts=meta_ts))
    mt = tm.MapContacts(idx1, r1, idx2, r2, cfg=ContactConfig(**cfg),
                        meta=ContactMeta(ts=meta_ts), device="cpu")
    want = mj.run(_batches(jm.FrameBatch, pos, box, size=size))
    got = mt.run(_batches(FrameBatch, pos, box, size=size))
    return got, want, mt


def test_mapper_dense_raw(rng):
    pos, r1, r2, A1 = _system(rng, F=10)
    got, want, mt = _both(pos, r1, r2, A1, _box("ortho", 10))
    assert_records_match(got, want, 10.0)
    assert mt.stats["passes"] == {"pruned": 0, "dense": 0, "dense_raw": 3}
    assert mt.stats["frames"] == 10 and mt.stats["batches"] == 3


def test_mapper_dense_compact_and_overflow(rng):
    pos, r1, r2, A1 = _system(rng, F=10)
    box = _box("ortho", 10)
    got, want, mt = _both(pos, r1, r2, A1, box, transfer_cap=40)
    assert_records_match(got, want, 10.0)
    assert mt.stats["passes"]["dense"] == 3
    assert mt.stats["dense_overflows"] == 0
    raw, _, _ = _both(pos, r1, r2, A1, box)
    over, want, mo = _both(pos, r1, r2, A1, box, transfer_cap=2)
    assert mo.stats["dense_overflows"] > 0
    assert_records_match(over, want, 10.0)
    for rec in (got, over):              # the three transfers, bit for bit
        np.testing.assert_array_equal(rec.frames, raw.frames)
        np.testing.assert_array_equal(rec.sel2_resids, raw.sel2_resids)
        np.testing.assert_array_equal(rec.min_dist, raw.min_dist)


def test_mapper_triclinic(rng):
    pos, r1, r2, A1 = _system(rng, F=5, spread=18.0)
    got, want, _ = _both(pos, r1, r2, A1, _box("triclinic", 5),
                         map_cutoff=7.0)
    assert_records_match(got, want, 7.0)


def test_mapper_pruned_adaptive_cap_growth(rng):
    F, R1, P1, R2, P2 = 3, 12, 3, 10, 3
    dense_pile = _system(rng, F, R1, P1, R2, P2, spread=6.0, sigma=0.5)
    sparse = _system(rng, F, R1, P1, R2, P2, spread=60.0, sigma=0.5)
    pos = np.concatenate([dense_pile[0], sparse[0]])
    _, r1, r2, A1 = dense_pile
    kw = dict(map_cutoff=10.0, prefilter_cap_min=16, use_pbc=False)
    got, want, mt = _both(pos, r1, r2, A1, None, size=3, prefilter=True,
                          **kw)
    assert_records_match(got, want, 10.0)
    assert mt.stats["retries_exact"] == 1 and mt.stats["cap"] > 16
    assert mt.stats["fallbacks_dense"] == 0
    assert mt.stats["passes"]["pruned"] == 3
    dense, _, _ = _both(pos, r1, r2, A1, None, size=3, prefilter=False, **kw)
    assert len(dense) > R1 * R2          # the pile really is dense
    np.testing.assert_array_equal(got.frames, dense.frames)
    np.testing.assert_array_equal(got.sel1_resids, dense.sel1_resids)
    np.testing.assert_array_equal(got.sel2_resids, dense.sel2_resids)
    np.testing.assert_array_equal(got.min_dist, dense.min_dist)


def test_mapper_pruned_falls_back_to_dense_past_the_ceiling(rng):
    pos, r1, r2, A1 = _system(rng, F=6)
    got, want, mt = _both(pos, r1, r2, A1, _box("ortho", 6), size=6,
                          prefilter=True, prefilter_cap=4)
    assert mt.stats["fallbacks_dense"] == 1
    assert_records_match(got, want, 10.0)


def test_mapper_prefilter_auto_follows_the_pair_count(rng):
    pos, r1, r2, A1 = _system(rng, F=4)
    _, _, mt = _both(pos, r1, r2, A1, _box("ortho", 4),
                     prefilter_auto_pairs=100)
    assert mt.stats["passes"]["pruned"] == 1
    _, _, mt = _both(pos, r1, r2, A1, _box("ortho", 4))
    assert mt.stats["passes"]["pruned"] == 0


@pytest.mark.parametrize("prefilter", [False, True])
def test_mapper_u16(rng, prefilter):
    pos, r1, r2, A1 = _system(rng, F=8)
    pos += 300.0                         # far from the origin
    box = _box("ortho", 8)
    got, want, _ = _both(pos, r1, r2, A1, box, upload_dtype="u16",
                         prefilter=prefilter)
    assert_records_match(got, want, 10.0)
    # against the unquantized host reference the format's bound applies
    step = float((pos.max(1) - pos.min(1)).max() / 65535.0)
    shared, lone, err = ref.check_records(
        got, range(8), lambda f: (pos[f], box[f]), np.arange(A1), r1,
        np.arange(A1, pos.shape[1]), r2, 10.0, atol=ATOL + 3 ** 0.5 * step)
    assert shared > 0


def test_mapper_scattered_selections_and_ragged_residues(rng):
    F, A = 6, 60
    pos = rng.uniform(0, 30, (F, A, 3)).astype(np.float32)
    perm = rng.permutation(A)
    idx1, idx2 = np.sort(perm[:17]), np.sort(perm[17:40])
    r1 = np.sort(rng.integers(1, 5, 17))
    r2 = np.sort(rng.integers(100, 106, 23))
    box = np.tile(np.array([20.0, 25.0, 30.0], np.float32), (F, 1))
    got, want, mt = _both(pos, r1, r2, None, box, idx=(idx1, idx2))
    assert not mt._layout_is_identity and mt._mask1 is not None
    assert_records_match(got, want, 10.0)
    shared, lone, err = ref.check_records(
        got, range(F), lambda f: (pos[f], box[f]), idx1, r1, idx2, r2, 10.0)
    assert shared > 0 and err <= ATOL


def test_mapper_spill(rng, tmp_path):
    pos, r1, r2, A1 = _system(rng, F=12)
    box = _box("ortho", 12)
    plain, _, _ = _both(pos, r1, r2, A1, box)
    mt = tm.MapContacts(np.arange(A1), r1, np.arange(A1, pos.shape[1]), r2,
                        cfg=ContactConfig(host_row_budget=20), device="cpu")
    got = mt.run(_batches(FrameBatch, pos, box), spill_dir=str(tmp_path))
    assert isinstance(got.frames, np.memmap)
    assert list(tmp_path.iterdir()) == []
    for f in ("frames", "sel1_resids", "sel2_resids", "min_dist", "times"):
        np.testing.assert_array_equal(getattr(got, f), getattr(plain, f))


def test_mapper_checkpoint_resume_with_other_batching(rng, tmp_path):
    pos, r1, r2, A1 = _system(rng, F=20)
    box = _box("ortho", 20)
    whole, want, _ = _both(pos, r1, r2, A1, box)
    assert_records_match(whole, want, 10.0)

    def mapper():
        return tm.MapContacts(np.arange(A1), r1,
                              np.arange(A1, pos.shape[1]), r2, device="cpu")

    class Preempted(RuntimeError):
        pass

    def dying():
        for i, b in enumerate(_batches(FrameBatch, pos, box, size=4)):
            if i == 3:
                raise Preempted
            yield b

    ck = str(tmp_path / "ckpt")
    with pytest.raises(Preempted):
        mapper().run(dying(), checkpoint_dir=ck, checkpoint_every=4)
    seen = []
    resumed = mapper().run(_batches(FrameBatch, pos, box, size=7),
                           checkpoint_dir=ck, checkpoint_every=4,
                           progress_cb=seen.append)
    assert seen[-1] == 20
    for f in ("frames", "sel1_resids", "sel2_resids", "min_dist", "times"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(whole, f))
    assert resumed.meta.ts == whole.meta.ts
    tm.MapContacts.remove_checkpoint(ck)
    assert not (tmp_path / "ckpt").exists()


def test_checkpoint_of_the_jax_package_is_refused(rng, tmp_path):
    pos, r1, r2, A1 = _system(rng, F=8)
    box = _box("ortho", 8)
    args = (np.arange(A1), r1, np.arange(A1, pos.shape[1]), r2)
    ck = str(tmp_path / "ckpt")
    jm.MapContacts(*args).run(_batches(jm.FrameBatch, pos, box),
                              checkpoint_dir=ck, checkpoint_every=4)
    with pytest.raises(ValueError, match="checkpoint"):
        tm.MapContacts(*args, device="cpu").run(
            _batches(FrameBatch, pos, box), checkpoint_dir=ck)


def _tiny(times, split, meta_ts=None):
    pos = np.zeros((len(times), 2, 3), np.float32)
    pos[:, 1, 0] = 2.0
    times = np.asarray(times, np.float64)
    ids = np.arange(len(times))
    out = []
    for cls, mod, cfg, meta in ((FrameBatch, tm, ContactConfig, ContactMeta),
                                (jm.FrameBatch, jm, JConfig, JMeta)):
        kw = {"device": "cpu"} if mod is tm else {}
        mc = mod.MapContacts(np.array([0]), np.array([1]), np.array([1]),
                             np.array([9]),
                             cfg=cfg(map_cutoff=10.0, use_pbc=False),
                             meta=meta(ts=meta_ts), **kw)
        out.append((mc, [cls(ids[:split], times[:split], pos[:split]),
                         cls(ids[split:], times[split:], pos[split:])]))
    return out


def test_mapper_ts_inference_equals_jax():
    (mt, bt), (mj, bj) = _tiny([0.0, 0.1, 0.2, 0.3], split=1)
    assert mt.run(bt).meta.ts == mj.run(bj).meta.ts
    F = 5000
    times = (np.arange(F) * 0.1).astype(np.float32).astype(np.float64)
    (mt, bt), (mj, bj) = _tiny(times, split=1717)
    a, b = mt.run(bt), mj.run(bj)
    assert a.meta.ts == b.meta.ts == pytest.approx(0.1, rel=1e-4)
    np.testing.assert_array_equal(a.times, b.times)


def test_mapper_irregular_stride_raises():
    for mc, batches in _tiny([0.0, 0.1, 0.3, 0.4], split=2):
        with pytest.raises(ValueError, match="irregular"):
            mc.run(batches)
    (mt, bt), _ = _tiny([0.0, 0.1, 0.3, 0.4], split=2, meta_ts=0.05)
    assert mt.run(bt).meta.ts == 0.05    # an explicit ts bypasses inference


def test_mapper_end_to_end_events(rng):
    pos, r1, r2, A1 = _system(rng, F=30, spread=30.0)
    pos[1:] = pos[0] + rng.normal(0, 0.3, pos[1:].shape).astype(np.float32)
    got, want, _ = _both(pos, r1, r2, A1, _box("ortho", 30), size=8)
    a = tm.ProcessContacts(7.0).run(got)
    b = jm.ProcessContacts(7.0).run(want)
    assert len(a) == len(b) > 0 and a.durations.max() > 0.1
    for f in ("sel1_resids", "sel2_resids", "start_times", "durations"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.MapContacts(np.array([0]), np.array([1]), np.array([1]),
                       np.array([9]))


def test_host_reference_is_independent_and_checks(rng):
    """The plain host version shares no code with the distance kernel and
    its comparison refuses a wrong row."""
    import inspect
    src = inspect.getsource(ref)
    assert "distances" not in src.split('"""', 2)[2]
    assert "import torch" not in src
    good = (np.array([1]), np.array([9]), np.array([3.0]))
    assert ref.check_frame(good, good, 10.0) == (1, 0, 0.0)
    with pytest.raises(AssertionError, match="one result only"):
        ref.check_frame(good, tuple(c[:0] for c in good), 10.0)
    with pytest.raises(AssertionError, match="differs"):
        ref.check_frame(good, (good[0], good[1], np.array([3.01])), 10.0)
    edge = (np.array([1]), np.array([9]), np.array([10.00005]))
    assert ref.check_frame(tuple(c[:0] for c in edge), edge, 10.0)[1] == 1
