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

from basicrta_torch.scripts import device_prng as dp

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
        got = dp.draw_uniform(seed).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,p", [(16, 0.35), (50, 0.3), (5000, 0.47),
                                 (40, 0.9)])
@pytest.mark.parametrize("mode", [True, "btrd_nat_h4"])
def test_binomials_match(jprng, n, p, mode):
    ref = np.asarray(jprng.draw_binom(jnp.int32(128), n=n, p=p,
                                      interpret=True, btrs_mode=mode))
    got = dp.draw_binom(128, n, p, btrs_mode=mode).numpy()
    # a 1-ulp difference in an accept test may move a rare draw
    assert (got == ref).mean() >= 0.999
    assert np.abs(got.mean() - ref.mean()) < 0.01 * n * p


@pytest.mark.parametrize("a", [0.0667, 3.7, 500.0])
def test_gammas_match(jprng, a):
    ref = np.asarray(jprng.draw_gamma(jnp.int32(11), a=a, interpret=True,
                                      early_exit=True))
    got = dp.draw_gamma(11, a).numpy()
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
