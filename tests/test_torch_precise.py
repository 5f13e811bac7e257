"""basicrta_torch.ops.precise and the counter-hash RNG against the JAX
package: bit-for-bit equal on the same f32 inputs.

The JAX functions run op by op: under ``jax.jit`` XLA:CPU fuses a
polynomial into one loop whose code generation may round differently
(1-2 ulp), and it flushes denormals to zero."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrta_tpu.ops import precise as jprecise
from basicrta_tpu.sampler import pallas_sweep as jsweep
from basicrta_torch.ops import precise
from basicrta_torch.sampler import cuda_sweep


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    if kind == "log":      # positive, 40 decades plus the near-1 band
        x = np.concatenate([10 ** rng.uniform(-38, 38, 20000),
                            rng.uniform(0.5, 2.0, 20000)])
    elif kind == "exp":    # the clamp range and beyond
        x = rng.uniform(-100.0, 100.0, 40000)
    elif kind == "gammaln":    # the x >= 6 branch: no native op
        x = 10 ** rng.uniform(0.79, 7, 20000)
    else:                  # stirling_tail: integers, negatives, large
        x = np.concatenate([np.arange(-5.0, 200.0),
                            np.floor(10 ** rng.uniform(0, 7, 10000)),
                            rng.uniform(-3.0, 30.0, 5000)])
    return x.astype(np.float32)


@pytest.mark.parametrize("name,kind", [("log_f32", "log"),
                                       ("exp_f32", "exp"),
                                       ("gammaln_f32", "gammaln"),
                                       ("stirling_tail", "stirling")])
def test_precise_op_bitwise(name, kind):
    x = _inputs(kind)
    ref = np.asarray(getattr(jprecise, name)(jnp.asarray(x)))
    got = getattr(precise, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("bits", [5, 8])
def test_pow_smallint_bitwise(bits):
    rng = np.random.default_rng(bits)
    q = rng.uniform(0.0, 1.0, 20000).astype(np.float32)
    n = rng.integers(0, 2 ** bits, 20000).astype(np.float32)
    ref = np.asarray(jprecise.pow_smallint(jnp.asarray(q), jnp.asarray(n),
                                           bits))
    got = precise.pow_smallint(torch.from_numpy(q), torch.from_numpy(n),
                               bits).numpy()
    # XLA:CPU flushes denormals to zero; a normal result never passed
    # through a denormal factor (every factor is >= the product)
    tiny = np.finfo(np.float32).tiny
    normal = ref >= tiny
    assert normal.mean() > 0.5
    np.testing.assert_array_equal(got[normal].view(np.int32),
                                  ref[normal].view(np.int32))
    assert np.all(got[~normal] < tiny)


def test_gammaln_small_branch():
    """Below 6 the shift correction is the native log, which differs by
    an ulp between XLA:CPU and torch in ~1% of inputs: equal to f32
    rounding of that term."""
    x = np.random.default_rng(6).uniform(1e-3, 6.0, 20000).astype(
        np.float32)
    ref = np.asarray(jprecise.gammaln_f32(jnp.asarray(x)))
    got = precise.gammaln_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert (got == ref).mean() > 0.95


def test_non_f32_falls_through_to_native():
    x = torch.tensor([0.5, 2.0, 10.0], dtype=torch.float64)
    assert torch.equal(precise.log_f32(x), torch.log(x))
    assert torch.equal(precise.exp_f32(x), torch.exp(x))


# int32 seeds including the wrap-around corners the kernel's per-sweep
# reseeding (seed * 2654435761 + sweep) produces
_SEEDS = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 123456789, -1640531535]


@pytest.mark.parametrize("seed", _SEEDS)
def test_hash_bits_and_uniform_bitwise(seed):
    shape = (3, 8, 128)
    lane, tag = 5, 17
    for t in (0, 3, 11):
        ref = np.asarray(jax.jit(
            lambda s: jsweep._hash_bits(s, lane, tag, t, shape))(
                jnp.int32(seed)))
        rows = torch.arange(3)[:, None, None]
        g = torch.arange(8)[None, :, None]
        cols = torch.arange(128)[None, None, :]
        elem = cuda_sweep._element_ids(rows, g, cols)
        got = cuda_sweep._hash_bits(seed, lane, tag, t, elem).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), ref)
        u_ref = np.asarray(jsweep._bits_to_uniform(jnp.asarray(ref)))
        u = cuda_sweep._bits_to_uniform(torch.from_numpy(
            ref.astype(np.int64))).numpy()
        np.testing.assert_array_equal(u.view(np.int32),
                                      u_ref.view(np.int32))


def test_rng_sites_match_hash():
    """_Rng numbers its call sites 1, 2, ... and reuses a reserved pair,
    as the traced Pallas kernel does."""
    lane = torch.tensor([0, 0, 1])
    g = torch.tensor([0, 1, 0])[:, None]
    cols = torch.arange(128)[None, :]
    fe = cuda_sweep._murmur_fmix(cuda_sweep._element_ids(0, g, cols))
    rng = cuda_sweep._Rng(99, lane)
    first = rng.uniform(fe)
    pair = rng.reserve(2)
    looped = rng.uniform(fe, 7, pair + 1)
    for got, tag, t in ((first, 1, 0), (looped, 3, 7)):
        bits = cuda_sweep._hash_bits(99, lane[:, None], tag, t,
                                     cuda_sweep._element_ids(0, g, cols))
        assert torch.equal(got, cuda_sweep._bits_to_uniform(bits))
