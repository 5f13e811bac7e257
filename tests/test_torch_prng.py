"""The device-PRNG probe (K5) of basicrta_torch against the JAX package's
``scripts/device_prng.py`` in interpret mode, draw for draw: the same
counter hash, call sites and element ids give the same uniforms, the same
binomials in both BTRS forms the port runs, and the same early-exit gamma
draws. The JAX script is loaded from its file, unchanged."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrta_torch.scripts import device_prng as dp


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small eager steps: with torch's intra-op threads, each step
    waits for threads that the suite's other workers keep busy. One
    thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jprng():
    spec = importlib.util.spec_from_file_location(
        "jax_device_prng", os.path.join(REPO, "scripts", "device_prng.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_uniform_bits_identical(jprng):
    for seed in (97, -5, 2 ** 31 - 1):
        ref = np.asarray(jprng.draw_uniform(jnp.int32(seed), interpret=True))
        got = dp.draw_uniform(seed, device="cpu").numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,p", [(16, 0.35), (50, 0.3), (5000, 0.47),
                                 (40, 0.9)])
@pytest.mark.parametrize("mode", [True, "btrd_nat_h4"])
def test_binomials_match(jprng, n, p, mode):
    ref = np.asarray(jprng.draw_binom(jnp.int32(128), n=n, p=p,
                                      interpret=True, btrs_mode=mode))
    got = dp.draw_binom(128, n, p, btrs_mode=mode, device="cpu")
    got = got.numpy()
    # a 1-ulp difference in an accept test may move a rare draw
    assert (got == ref).mean() >= 0.999
    assert np.abs(got.mean() - ref.mean()) < 0.01 * n * p


@pytest.mark.parametrize("a", [0.0667, 3.7, 500.0])
def test_gammas_match(jprng, a):
    ref = np.asarray(jprng.draw_gamma(jnp.int32(11), a=a, interpret=True,
                                      early_exit=True))
    got = dp.draw_gamma(11, a, device="cpu").numpy()
    # XLA's fused CPU code rounds Acklam's inverse-normal polynomial
    # differently from torch's op-by-op arithmetic (measured up to 1.3e-3
    # relative, in 1-17% of draws by shape; a < 1 also amplifies through
    # U^(1/a)); a draw whose accept test flips moves further, rarely
    close = np.isclose(got, ref, rtol=2e-3, atol=0)
    assert close.mean() >= 0.999


def test_unported_forms_are_refused():
    with pytest.raises(ValueError, match="not run by the port"):
        dp.draw_binom(1, 50, 0.3, btrs_mode="btrd")
    with pytest.raises(ValueError, match="unknown draw kind"):
        dp.draw_plain("normal", 1)


def test_battery_passes_on_the_plain_draws():
    """The battery itself on the plain versions: every ported form passes
    and the unported forms are listed as not run."""
    lines = []
    failures, not_run = dp.run_battery("cpu", out=lines.append)
    assert failures == [], lines
    assert "binom btrd_nat" in not_run
    assert any("btrd_nat_h4" in line for line in lines)
    assert lines[-1].startswith("not run")


@pytest.mark.parametrize("kind,n,p,a", [("uniform", 0, 0, 0),
                                        ("binom_lgamma", 5000, 0.47, 0),
                                        ("binom_h4", 5000, 0.47, 0),
                                        ("binom_h4", 16, 0.35, 0),
                                        ("gamma", 0, 0, 0.0667),
                                        ("gamma", 0, 0, 3.7)])
def test_many_tile_launch_keeps_each_tiles_bits(kind, n, p, a):
    """Plain version of the many-tile launch: tile t is bit for bit the
    one-tile draw at seed + t * stride, also across the plain version's
    chunks, so the battery's one launch a sample changes no draw."""
    many = dp.draw_plain(kind, 97, n, p, a, tiles=3)
    assert many.shape == (3, dp.ROWS, 128)
    for t in range(3):
        one = dp.draw_plain(kind, 97 + t * dp.SEED_STRIDE, n, p, a)
        assert one.shape == (dp.ROWS, 128)
        np.testing.assert_array_equal(many[t].numpy(), one.numpy())
    # draw_kernel on the CPU is the plain version
    other = dp.draw_kernel(kind, 5, n, p, a, device="cpu", tiles=2)
    np.testing.assert_array_equal(
        other[1].numpy(),
        dp.draw_plain(kind, 5 + dp.SEED_STRIDE, n, p, a).numpy())


def test_many_tile_chunks_and_the_batterys_sample(monkeypatch):
    monkeypatch.setattr(dp, "_PLAIN_CHUNK", 2)
    many = dp.draw_plain("uniform", 97, tiles=5)
    monkeypatch.undo()
    np.testing.assert_array_equal(many.numpy(),
                                  dp.draw_plain("uniform", 97,
                                                tiles=5).numpy())
    # collect(): the seeds 97, 128, ... of the reference's battery, in order
    got = dp.collect(dp.draw_uniform, 3, device="cpu")
    want = np.concatenate([
        dp.draw_uniform(97 + 31 * s, device="cpu").numpy().ravel()
        for s in range(3)])
    np.testing.assert_array_equal(got, want)


def test_timing_needs_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dp.time_draws("cpu")
    assert dp.TIMING_TILES * dp.ROWS * 128 * 4 == 512 * 2 ** 20


@pytest.mark.parametrize("draw", [
    lambda: dp.draw_uniform(97), lambda: dp.draw_binom(97, 5000, 0.47),
    lambda: dp.draw_binom(97, 50, 0.3, btrs_mode="btrd_nat_h4"),
    lambda: dp.draw_gamma(97, 3.7), lambda: dp.draw_kernel("gamma", 1),
    lambda: dp.draw_stats("binom_h4", 1, 5000, 0.47)])
def test_entry_points_default_to_the_card(draw, monkeypatch):
    """With no device named the draws launch on the card; without one they
    raise, naming CUDA, before building anything and without a fallback
    to the plain version."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(dp, "_library", None)    # a build would fail here
    calls = dp.draw_plain.calls
    with pytest.raises(RuntimeError, match="CUDA"):
        draw()
    assert dp.draw_plain.calls == calls
