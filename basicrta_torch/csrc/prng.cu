// The device-PRNG probe (K5) for Hopper (sm_90a): raw draws of the sweep
// kernels' in-kernel samplers on a (rows, 128) tile, for the goodness-of-
// fit battery of basicrta_torch/scripts/device_prng.py.
//
// What it replaces: basicrta_tpu scripts/device_prng.py _call and
// draw_uniform / draw_binom / draw_gamma, tiny Pallas kernels that emit the
// same samplers' draws on a (256, 128) tile with lane id 1.
//
// What bounds it: one (256, 128) tile is 128 KB and costs a launch; a launch
// over thousands of tiles (blockIdx.y; tile t draws with seed + t *
// seed_stride, so its bits are those of a one-tile launch at that seed) is
// bound by the bytes it writes or by its samplers' transcendentals
// (basicrta_torch/scripts/roofline.py prng_bound). The
// point is that the draws come from the very device code the sweep
// kernels run (samplers.cuh, built with the same flags), with the JAX
// package's call sites: the uniform on site 1; binom_full with its
// inversion uniform on site 1 and BTRS from site 2 (the lgamma form of K1
// or the btrd_nat_h4 form of K2); the early-exit Marsaglia-Tsang gamma of
// K2's conjugate draw on sites 1-3.
//
// Design: one thread per element, element id row * 0x27D4EB2F + col (the
// reference's two-axis iota combination).

#include "samplers.cuh"

namespace {

using namespace basicrta;

enum Kind { kUniform = 0, kBinomLgamma = 1, kBinomH4 = 2, kGammaEarly = 3 };

__global__ void __launch_bounds__(kLanes)
prng_kernel(float* out, int kind, int seed, int seed_stride, float n, float p,
            float a) {
  const uint32_t row = blockIdx.x, col = threadIdx.x, tile = blockIdx.y;
  const uint32_t fe = fmix(row * kElemMul + col);
  const Rng rng = make_rng(uint32_t(seed) + tile * uint32_t(seed_stride), 1u);
  float x;
  switch (kind) {
    case kUniform:
      x = rng.uniform(1, 0, fe);
      break;
    case kBinomLgamma:
      x = binom_full<false>(rng, 0, fe, n, p);
      break;
    case kBinomH4:
      x = binom_full<true>(rng, 0, fe, n, p);
      break;
    default:
      x = gamma_mt(rng, 1, fe, a);
      break;
  }
  out[(size_t(tile) * gridDim.x + row) * kLanes + col] = x;
}

}  // namespace

extern "C" int basicrta_prng_draws(float* out, int rows, int tiles, int kind,
                                   int seed, int seed_stride, float n, float p,
                                   float a, void* stream) {
  if (kind < kUniform || kind > kGammaEarly || rows < 1 || tiles < 1 ||
      tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prng_kernel<<<dim3(rows, tiles), kLanes, 0,
                static_cast<cudaStream_t>(stream)>>>(out, kind, seed,
                                                     seed_stride, n, p, a);
  return static_cast<int>(cudaGetLastError());
}
