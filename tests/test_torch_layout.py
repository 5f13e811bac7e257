"""The bucket layout and the batch driver of basicrta_torch against the JAX
package: ``bucket_residues`` gives the same buckets (names, pack, mixed
widths, rows, tiers, values, counts) on every ladder, and
``run_residues`` on the production layout draws what the JAX fused
engine draws in interpret mode."""

import os

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, see conftest)
import numpy as np
import pytest

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.sampler import batch as jbatch
from basicrta_torch.interop import from_jax_batch
from basicrta_torch.sampler import batch


def _discretize(x, ts=0.1):
    return np.maximum(np.round(np.asarray(x) / ts), 1.0) * ts


def _workload(n, seed, lo=2.0, hi=4.3):
    """make_workload-style residues: log-uniform event counts, a
    five-component hyperexponential with a per-residue rate scale."""
    rng = np.random.default_rng(seed)
    w = np.array([0.87, 0.09, 0.03, 0.009, 0.001])
    r = np.array([4.7, 1.3, 0.33, 0.06, 0.009])
    out = {}
    for i, size in enumerate((10 ** rng.uniform(lo, hi, n)).astype(int)):
        comp = rng.choice(5, size=size, p=w)
        x = -np.log(rng.random(size)) / (r * rng.uniform(0.7, 1.5))[comp]
        out[f"R{i}"] = _discretize(np.sort(x))
    return out


def _assert_same_buckets(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.names == b.names
        assert (a.pack, a.phys_rows, a.tiers) == (b.pack, b.phys_rows,
                                                  tuple(b.tiers))
        if b.bounds is None:
            assert a.bounds is None
        else:
            np.testing.assert_array_equal(a.bounds, b.bounds)
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.n_events, b.n_events)


@pytest.fixture(scope="module")
def forty():
    times = _workload(40, 0)
    times["empty"] = np.zeros(0)
    return times


@pytest.mark.parametrize("kw", [{}, {"ladder": "pow2"},
                                {"consolidate": False},
                                {"mixed_pack": False}, {"floor": 256},
                                {"kmax": 4}])
def test_bucket_residues_equals_jax(forty, kw):
    got = batch.bucket_residues(forty, **kw)
    ref = jbatch.bucket_residues(forty, **kw)
    _assert_same_buckets(got, ref)
    assert batch.modeled_work_waste(got) == pytest.approx(
        jbatch.modeled_work_waste(ref), rel=1e-12)


def test_production_layout_packs_mixed_widths(forty):
    """The default layout of 40 residues x 2 chains packs k-way mixed
    buckets, and their physical packing equals the JAX package's."""
    lanes = {f"{k}#{c}": t for k, t in forty.items() for c in range(2)}
    got = batch.bucket_residues(lanes)
    _assert_same_buckets(got, jbatch.bucket_residues(lanes))
    mixed = [b for b in got if b.bounds is not None]
    assert mixed and max(b.pack for b in mixed) >= 4
    for b in mixed:
        v, c, seg, slot = batch._pack_mixed(
            b.values.astype(np.float32), b.counts.astype(np.float32),
            b.bounds, b.phys_rows)
        jv, jc, jseg, jslot = jbatch._pack_mixed(
            b.values.astype(np.float32), b.counts.astype(np.float32),
            b.bounds, b.phys_rows)
        for x, y in ((v, jv), (c, jc), (seg, jseg), (slot, jslot)):
            np.testing.assert_array_equal(x, y)
        assert batch._mixed_row_tiers(c) == jbatch._mixed_row_tiers(jc)
        np.testing.assert_array_equal(c.sum((1, 2)), np.bincount(
            slot // b.pack, weights=b.counts.sum(1),
            minlength=len(b.bounds)))


def test_from_jax_batch_carries_packed_layouts(forty):
    lanes = {f"{k}#{c}": t for k, t in forty.items() for c in range(2)}
    for jb in jbatch.bucket_residues(lanes) + jbatch.bucket_residues(
            lanes, consolidate=False):
        b = from_jax_batch(jb)
        assert (b.pack, b.phys_rows, b.names) == (jb.pack, jb.phys_rows,
                                                  jb.names)
        assert (b.bounds is None) == (jb.bounds is None)
        if jb.bounds is not None:
            np.testing.assert_array_equal(b.bounds, jb.bounds)


@pytest.fixture(scope="module")
def five():
    """Six residues whose production layout (x 2 chains) is one mixed
    bucket."""
    return _workload(6, 0, lo=2.0, hi=4.7)


@pytest.mark.parametrize("n,mixed", [(6, True), (4, False)])
def test_run_residues_production_layout_matches_jax(n, mixed):
    """4-6 residues x 2 chains at 2 blocks: a mixed bucket (K3) and an
    unpacked one (K2) against the JAX fused engine's interpret path."""
    times = _workload(n, 0, lo=2.0, hi=4.7)
    cfg = GibbsConfig(ncomp=4, niter=20, g=10, seed=5)
    lanes = {f"{k}#{c}": t for k, t in times.items() for c in range(2)}
    layout = batch.bucket_residues(lanes)
    assert [b.bounds is not None for b in layout] == [mixed]
    assert (layout[0].pack > 1) == mixed
    ref = jbatch.run_residues(times, cfg, n_chains=2, engine="pallas")
    got = batch.run_residues(times, cfg, n_chains=2, engine="torch",
                             ladder=None)
    assert set(got) == set(ref)
    same = [np.allclose(got[k][i][c], ref[k][i][c], rtol=1e-4)
            for k in ref for i in range(2) for c in range(2)]
    assert sum(same) >= len(same) - 2, same


def test_run_residues_ladder_follows_the_engine(five, monkeypatch):
    seen = []
    orig = batch.bucket_residues

    def spy(times, **kw):
        seen.append(kw.get("ladder"))
        return orig(times, **kw)

    monkeypatch.setattr(batch, "bucket_residues", spy)
    cfg = GibbsConfig(ncomp=3, niter=10, g=10)
    small = {"A": five["R0"]}
    batch.run_residues(small, cfg, engine="torch")
    batch.run_residues(small, cfg, engine="torch", ladder=None)
    assert seen == ["pow2", None]


@pytest.mark.parametrize("mixed", [True, False])
def test_packed_checkpoint_resume(tmp_path, five, mixed):
    """A packed bucket's run resumes exactly from a checkpoint of its B
    members (scattered back into the kernel's slots), under an engine tag
    naming the pack and the mixed widths."""
    lanes = {f"{k}#{c}": t for k, t in five.items() for c in range(2)}
    layout = (batch.bucket_residues(lanes) if mixed
              else batch.bucket_residues(lanes, consolidate=False))
    b = next(x for x in layout if (x.bounds is not None) == mixed
             and x.pack > 1)
    cfg = GibbsConfig(ncomp=3, niter=60, g=10, seed=9)
    full = batch.run_batch(b, cfg, segment_blocks=2, engine="torch")
    ckpt = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def bomb(seg_idx, state, _):
        if seg_idx == 2:
            raise Stop

    with pytest.raises(Stop):
        batch.run_batch(b, cfg, segment_blocks=2, checkpoint_path=ckpt,
                        checkpoint_cb=bomb, engine="torch")
    # the unpacked engine tag never resumes a packed bucket's state
    assert batch.load_checkpoint(ckpt, b, cfg, "basicrta_torch-torch") is None
    tag = f"basicrta_torch-torch-p{b.pack}"
    if mixed:
        import zlib
        crc = zlib.crc32(np.asarray(b.bounds, np.int64).tobytes())
        tag += f"-mx{crc & 0xffff:04x}"
    done, _, state, Ws, _ = batch.load_checkpoint(ckpt, b, cfg, tag)
    assert done == 4 and state.weights.shape == (b.size, 3)
    assert Ws[0].shape == (b.size, 4, 3)
    resumed = batch.run_batch(b, cfg, segment_blocks=3, checkpoint_path=ckpt,
                              engine="torch")
    np.testing.assert_array_equal(resumed.mcweights, full.mcweights)
    np.testing.assert_array_equal(resumed.mcrates, full.mcrates)
    assert not os.path.exists(ckpt)
