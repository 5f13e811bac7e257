"""The sampler roofline of basicrta_torch against the JAX package: the
static transcendental count per sweep (exactly, on every bucket of the
benchmark workload's production, uniform and pow2 layouts), the
transcendental ceiling's plain version against the same body in
``jax.numpy`` (bench.py's Pallas kernel needs a TPU), and
``vpu_transcendental_util`` against bench.py's formula.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrta_tpu.ops.surv import discretize_times, simulate_hyperexp
from basicrta_tpu.sampler import batch as jbatch
from basicrta_tpu.sampler import pallas_sweep as jsweep
from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch, cuda_sweep
from basicrta_torch.scripts import roofline
from basicrta_torch.scripts.workload import make_workload


@pytest.fixture(scope="module")
def workload():
    return {f"R{i}": t for i, t in make_workload().items()}


def test_workload_is_the_bench_recipe():
    """The port's copy draws bench.py's residues from the same seed."""
    got = make_workload(6)
    rng = np.random.default_rng(0)
    w = np.array([0.87, 0.09, 0.03, 0.009, 0.001])
    r = np.array([4.7, 1.3, 0.33, 0.06, 0.009])
    sizes = np.concatenate([[446605],
                            (10 ** rng.uniform(2.0, 5.3, 5)).astype(int)])
    for i, n in enumerate(sizes):
        scale = rng.uniform(0.7, 1.5)
        ref = discretize_times(simulate_hyperexp(int(n), w, r * scale, rng),
                               0.1)
        np.testing.assert_array_equal(got[i], ref)


def _jax_phys(b):
    """bench.py's ``_phys`` of a bucket."""
    if b.bounds is None:
        return None
    _, c_ph, _, _ = jbatch._pack_mixed(
        np.asarray(b.values, np.float32), np.asarray(b.counts, np.float32),
        b.bounds, b.phys_rows)
    return (b.phys_rows, *jbatch._mixed_row_tiers(c_ph), len(b.bounds))


@pytest.mark.parametrize("layout", ["production", "uniform", "pow2"])
def test_transcendentals_per_sweep_equals_jax(workload, layout):
    kw = {"production": {}, "uniform": dict(mixed_pack=False),
          "pow2": dict(ladder="pow2")}[layout]
    batches = batch.bucket_residues(workload, **kw)
    assert len(batches) > 1
    for K in (15, 5):
        for b in batches:
            args = (b.size, b.values.shape[1], b.pack, b.tiers, K)
            assert (cuda_sweep.transcendentals_per_sweep(
                *args, phys=roofline._phys(b))
                == jsweep.transcendentals_per_sweep(*args,
                                                    phys=_jax_phys(b)))
    # explicit phys without a lane count falls back to ceil(B / pack)
    assert (cuda_sweep.transcendentals_per_sweep(40, 256, 4, (3, 9), 15,
                                                 phys=(4, 1, 2))
            == jsweep.transcendentals_per_sweep(40, 256, 4, (3, 9), 15,
                                                phys=(4, 1, 2)))


def _ceiling_body_jax(iters, tiles, scale=1e-9):
    """bench.py transcendental_ceiling's kernel body, in jax.numpy (its
    step is exp(x * 1e-9); ``scale`` replaces the 1e-9)."""
    xs = [jnp.full((256, 128), 0.5 + 0.1 * t, jnp.float32)
          for t in range(tiles)]
    for _ in range(iters):
        xs = [jnp.exp(x * scale) for x in xs]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return np.asarray(acc)


def test_ceiling_tile_matches_jax():
    got = roofline.ceiling_tile_torch(iters=20, tiles=4).numpy()
    np.testing.assert_allclose(got, _ceiling_body_jax(20, 4), rtol=1e-6)
    assert got.shape == (256, 128)
    # at bench.py's scale every chain is 1.0 after one step; the check
    # scale keeps each step visible, so a wrong step count cannot match
    s = roofline.CHECK_SCALE
    got = roofline.ceiling_tile_torch(iters=12, tiles=4, scale=s).numpy()
    np.testing.assert_allclose(got, _ceiling_body_jax(12, 4, s), rtol=1e-6)
    fewer = roofline.ceiling_tile_torch(iters=11, tiles=4, scale=s).numpy()
    assert not np.allclose(fewer, got, rtol=1e-5, atol=0)


def test_ceiling_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    monkeypatch.setattr(roofline, "TILES", 3)
    out = torch.empty((256, 128))
    before = roofline.ceiling_tile.launches
    roofline.ceiling_tile(out, iters=5)
    np.testing.assert_array_equal(out.numpy(),
                                  roofline.ceiling_tile_torch(5, 3).numpy())
    assert roofline.ceiling_tile.launches == before
    with pytest.raises(ValueError, match="tile"):
        roofline.ceiling_tile(torch.empty((128, 128)))
    roofline.ceiling_tile(out, iters=5, scale=roofline.CHECK_SCALE)
    np.testing.assert_array_equal(
        out.numpy(), roofline.ceiling_tile_torch(
            5, 3, scale=roofline.CHECK_SCALE).numpy())
    with pytest.raises(RuntimeError, match="CUDA device"):
        roofline._best_seconds(lambda: None, "cpu")


@pytest.mark.parametrize("layout", ["production", "pow2"])
def test_needed_transcendentals_is_below_the_static_count(workload, layout):
    """The bounds' count: K exps per non-empty column plus 2K gammas of
    three transcendentals per real lane, never above the static count."""
    kw = {"production": {}, "pow2": dict(ladder="pow2")}[layout]
    for b in batch.bucket_residues(workload, **kw):
        counts = batch._kernel_layout(b)[1]
        got = roofline.needed_transcendentals(counts, b.size, 15)
        assert got == (15 * int((np.asarray(b.counts) > 0).sum())
                       + 2 * 15 * b.size * roofline.GAMMA_FLOOR)
        assert roofline.needed_transcendentals(
            counts, b.size, 15, conjugate=False) == 15 * int(
                (np.asarray(b.counts) > 0).sum())
        assert got <= cuda_sweep.transcendentals_per_sweep(
            b.size, b.values.shape[1], b.pack, b.tiers, 15,
            phys=roofline._phys(b))


def test_vpu_transcendental_util_is_bench_formula(workload):
    """bench.py: per-sweep count over the buckets x aggregate sweeps/s /
    lanes / ceiling, on fixed inputs."""
    lanes = dict(list(workload.items())[:60])
    batches = batch.bucket_residues(lanes)
    assert any(b.bounds is not None for b in batches)
    cfg = GibbsConfig(ncomp=15, niter=2000)
    agg, ceiling = 1.75e6, 3.9e12
    per_sweep = sum(jsweep.transcendentals_per_sweep(
        b.size, b.values.shape[1], b.pack, b.tiers, cfg.ncomp,
        phys=_jax_phys(b)) for b in batches)
    ref = per_sweep * agg / sum(b.size for b in batches) / ceiling
    got = roofline.vpu_transcendental_util(batches, agg, cfg, ceiling)
    assert got == pytest.approx(ref, rel=1e-12)
    assert roofline.sfu_peak(1980.0) == pytest.approx(4.18176e12)


def test_prng_bound_is_the_larger_of_bytes_and_transcendentals():
    """K5's bound at its timed size: bytes written over the memory rate
    against the draws' transcendentals (set-up + one round) over the
    ceiling; ``bound_by`` names the larger."""
    from basicrta_torch.scripts import device_prng as dp
    rf = roofline
    draws = dp.TIMING_TILES * dp.ROWS * 128
    t_bytes = 1e3 * 4 * draws / rf.HBM_BYTES_PER_S
    ms, by, per = rf.prng_bound("uniform", draws, 2.9e12)
    assert (by, per) == ("bytes", 0.0) and ms == pytest.approx(t_bytes)
    # BTRS at (5000, 0.47): sqrt + log, and 3 logs past the squeeze
    b = 1.15 + 2.53 * (5000 * 0.47 * 0.53) ** 0.5
    slow = 1.0 - 0.86 * (0.92 - 4.2 / b)
    ms, by, per = rf.prng_bound("binom_h4", draws, 2.9e12, 5000, 0.47)
    assert per == pytest.approx(2.0 + 3.0 * slow) and by == "bytes"
    ms, by, per = rf.prng_bound("binom_lgamma", draws, 2.9e12, 5000, 0.47)
    assert per == pytest.approx(4.0 + 3.0 * slow) and by == "operations"
    assert ms == pytest.approx(1e3 * per * draws / 2.9e12) and ms > t_bytes
    # p > 1/2 folds; inversion below n p = 10; the gamma's boost below 1
    assert rf.prng_transcendentals_per_draw("binom_h4", 5000, 0.53) == \
        pytest.approx(2.0 + 3.0 * slow)
    assert rf.prng_transcendentals_per_draw("binom_h4", 16, 0.35) == 2.0
    assert rf.prng_transcendentals_per_draw("gamma", a=3.7) == rf.GAMMA_FLOOR
    assert rf.prng_transcendentals_per_draw("gamma", a=0.0667) == \
        rf.GAMMA_FLOOR + 2
    # a slower ceiling turns the same launch operation-bound
    assert rf.prng_bound("binom_h4", draws, 1e12, 5000, 0.47)[1] == \
        "operations"
    with pytest.raises(ValueError, match="unknown draw kind"):
        rf.prng_bound("normal", draws, 2.9e12)
