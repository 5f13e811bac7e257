// Device code shared by the sweep kernels (sweep.cu) and the PRNG probe
// (prng.cu): the JAX package's counter-hash RNG, its precise f32 log/exp/
// lgamma, and the in-kernel samplers of basicrta_tpu/sampler/
// pallas_sweep.py (CDF-inversion and BTRS binomials, the Marsaglia-Tsang
// gamma), with the reference's call-site numbering. Each source builds
// into a library of its own with its own copy of this code.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace basicrta {

constexpr int kLanes = 128;          // columns per row
constexpr int kKMax = 32;
constexpr int kInvFull = 32;
constexpr int kInvSmall = 17;        // SMALL_NMAX + 1
constexpr int kBtrsRounds = 12;
constexpr int kBtrsUnroll = 4;
constexpr int kMtRounds = 8;
constexpr float kTiny = 1e-30f;
constexpr uint32_t kElemMul = 0x27D4EB2Fu;

// The block's dynamic shared memory. A host build
// (BASICRTA_HOST_EMULATION) takes it from its <cuda_runtime.h>.
#ifndef BASICRTA_HOST_EMULATION
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float smem[];
  return smem;
}
#endif

// ------------------------------------------------------------------ RNG

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t elem_id(uint32_t row, uint32_t g,
                                            uint32_t col) {
  return (row * kElemMul + g) * kElemMul + col;
}

struct Rng {
  uint32_t h0;  // seed * 0x9E3779B9 ^ lane * 0x85EBCA6B
  __device__ __forceinline__ float uniform(int site, int t,
                                           uint32_t fe) const {
    uint32_t h = fmix(h0 ^ (uint32_t(site) * 0xC2B2AE35u + uint32_t(t)));
    uint32_t bits = fmix(h ^ fe);
    float u = float(int(bits >> 8)) * float(1.0 / 16777216.0);
    return fmaxf(u, float(1.0 / 33554432.0));
  }
};

__device__ __forceinline__ Rng make_rng(uint32_t seed, uint32_t lane) {
  return Rng{(seed * 0x9E3779B9u) ^ (lane * 0x85EBCA6Bu)};
}

// ------------------------------------------------------- precise f32 ops

__device__ __forceinline__ float log_f32(float x) {
  int bits = __float_as_int(x);
  int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  if (m > 1.4142135f) {
    m = m * 0.5f;
    e += 1;
  }
  float s = (m - 1.0f) / (m + 1.0f);
  float s2 = s * s;
  float p = 2.0f * s *
            (1.0f + s2 * (float(1.0 / 3.0) +
                          s2 * (float(1.0 / 5.0) +
                                s2 * (float(1.0 / 7.0) + s2 / 9.0f))));
  return p + float(e) * float(0.6931471805599453);
}

__device__ __forceinline__ float exp_f32(float x) {
  x = fminf(fmaxf(x, -87.0f), 88.0f);
  float kf = rintf(x * float(1.4426950408889634));  // half to even
  float r = (x - kf * 0.693359375f) - kf * float(-2.12194440e-4);
  float p = 1.0f + r * (1.0f + r * (0.5f + r * (float(1.0 / 6.0) +
            r * (float(1.0 / 24.0) + r * (float(1.0 / 120.0) +
            r * (float(1.0 / 720.0) + r / 5040.0f))))));
  float scale = __int_as_float((int(kf) + 127) << 23);
  return p * scale;
}

__device__ __forceinline__ float gammaln_f32(float x) {
  bool small = x < 6.0f;
  float xb = small ? x : 1.0f;
  float prod = xb * (xb + 1.0f) * (xb + 2.0f) * (xb + 3.0f) * (xb + 4.0f) *
               (xb + 5.0f);
  float xs = small ? x + 6.0f : x;
  float inv = 1.0f / xs;
  float inv2 = inv * inv;
  float series = inv * (float(1.0 / 12.0) -
                        inv2 * (float(1.0 / 360.0) - inv2 / 1260.0f));
  float lg = (xs - 0.5f) * log_f32(xs) - xs + float(0.9189385332046727) +
             series;
  return lg - (small ? logf(prod) : 0.0f);
}

__constant__ float kStTable[10] = {
    float(0.08106146679532726), float(0.04134069595540929),
    float(0.02767792568499834), float(0.02079067210376509),
    float(0.01664469118982119), float(0.01387612882307075),
    float(0.01189670994589177), float(0.01041126526197209),
    float(0.00925546218271273), float(0.00833056343336287)};

__device__ __forceinline__ float stirling_tail(float x) {
  float w = x + 1.0f;
  float inv = 1.0f / w;
  float inv2 = inv * inv;
  float s = inv * (float(1.0 / 12.0) -
                   inv2 * (float(1.0 / 360.0) - inv2 / 1260.0f));
  for (int i = 9; i >= 0; --i) {
    if (x < float(i) + 0.5f) s = kStTable[i];
  }
  return s;
}

__device__ __forceinline__ float pow_smallint5(float q, float n) {
  float result = 1.0f, base = q, e = n;
  for (int i = 0; i < 5; ++i) {
    float half = floorf(e * 0.5f);
    float odd = e - 2.0f * half;
    result = result * (odd > 0.5f ? base : 1.0f);
    base = base * base;
    e = half;
  }
  return result;
}

// ---------------------------------------------------------------- samplers

template <bool kSmallInt>
__device__ __forceinline__ float binom_inversion(float u, float n, float p,
                                                 int depth) {
  float q = fmaxf(1.0f - p, kTiny);
  float ratio = p / q;
  float pmf = kSmallInt ? pow_smallint5(q, n) : exp_f32(n * log_f32(q));
  float cdf = pmf;
  float m = 0.0f;
  // m only grows while u > cdf and cdf never decreases: stop at the
  // first covered step
  for (int t = 0; t < depth && u > cdf; ++t) {
    m += 1.0f;
    float tf = float(t);
    pmf = (n - tf > 0.0f) ? pmf * ratio * (n - tf) / (tf + 1.0f) : 0.0f;
    cdf = cdf + pmf;
  }
  return fminf(m, n);
}

// Requires n*p > 10, p <= 0.5. kH4: the btrd_nat_h4 accept test and site
// layout (rounds 0-3 own two sites each, later rounds share the loop
// body's two); otherwise the lgamma form with one shared pair of sites.
template <bool kH4>
__device__ float binom_btrs(const Rng& rng, int site0, uint32_t fe, float n,
                            float p) {
  float q = 1.0f - p;
  float spq = sqrtf(n * p * q);
  float b = 1.15f + 2.53f * spq;
  float a = -0.0873f + 0.0248f * b + 0.01f * p;
  float c = n * p + 0.5f;
  float vr = 0.92f - 4.2f / b;
  float alpha = (2.83f + 5.1f / b) * spq;
  float r = fmaxf(p / q, kTiny);
  float m = floorf((n + 1.0f) * p);
  float nm = n - m + 1.0f;
  float hb = 0.0f, h = 0.0f, lpq = 0.0f;
  if (kH4) {
    hb = (m + 0.5f) * log_f32(fmaxf((m + 1.0f) / (r * nm), kTiny)) +
         stirling_tail(m) + stirling_tail(n - m);
  } else {
    lpq = log_f32(r);
    h = gammaln_f32(m + 1.0f) + gammaln_f32(n - m + 1.0f);
  }
  for (int t = 0; t < kBtrsRounds; ++t) {
    int site = kH4 ? (t < kBtrsUnroll ? site0 + 2 * t
                                      : site0 + 2 * kBtrsUnroll)
                   : site0;
    float u = rng.uniform(site, t, fe) - 0.5f;
    float v = rng.uniform(site + 1, t, fe);
    float us = 0.5f - fabsf(u);
    float k = floorf((2.0f * a / us + b) * u + c);
    if (!(k >= 0.0f && k <= n)) continue;
    if (us >= 0.07f && v <= vr) return k;
    float vv = logf(fmaxf(v * alpha / (a / (us * us) + b), kTiny));
    bool slow;
    if (kH4) {
      float nk = n - k + 1.0f;
      slow = vv <= (hb + (n + 1.0f) * logf(fmaxf(nm / nk, kTiny)) +
                    (k + 0.5f) * logf(fmaxf(nk * r / (k + 1.0f), kTiny)) -
                    stirling_tail(k) - stirling_tail(n - k));
    } else {
      slow = vv <= (h - gammaln_f32(k + 1.0f) - gammaln_f32(n - k + 1.0f) +
                    (k - m) * lpq);
    }
    if (slow) return k;
  }
  return m;
}

// Sites of one stage: the inversion uniform, then BTRS's.
template <bool kH4>
__device__ __forceinline__ float binom_full(const Rng& rng, int stage_site,
                                            uint32_t fe, float n, float p) {
  p = fminf(fmaxf(p, 0.0f), 1.0f);
  if (p <= 0.0f || n <= 0.0f) return 0.0f;
  if (p >= 1.0f) return n;
  bool flip = p > 0.5f;
  float pe = flip ? 1.0f - p : p;
  float m;
  if (n * pe <= 10.0f) {
    m = binom_inversion<false>(rng.uniform(stage_site + 1, 0, fe), n, pe,
                               kInvFull);
  } else {
    m = binom_btrs<kH4>(rng, stage_site + 2, fe, n, pe);
  }
  m = flip ? n - m : m;
  return fminf(fmaxf(m, 0.0f), n);
}

__device__ float normal_icdf(float p) {
  const float a0 = float(-3.969683028665376e+01),
              a1 = float(2.209460984245205e+02),
              a2 = float(-2.759285104469687e+02),
              a3 = float(1.383577518672690e+02),
              a4 = float(-3.066479806614716e+01),
              a5 = float(2.506628277459239e+00);
  const float b0 = float(-5.447609879822406e+01),
              b1 = float(1.615858368580409e+02),
              b2 = float(-1.556989798598866e+02),
              b3 = float(6.680131188771972e+01),
              b4 = float(-1.328068155288572e+01);
  const float c0 = float(-7.784894002430293e-03),
              c1 = float(-3.223964580411365e-01),
              c2 = float(-2.400758277161838e+00),
              c3 = float(-2.549732539343734e+00),
              c4 = float(4.374664141464968e+00),
              c5 = float(2.938163982698783e+00);
  const float d0 = float(7.784695709041462e-03),
              d1 = float(3.224671290700398e-01),
              d2 = float(2.445134137142996e+00),
              d3 = float(3.754408661907416e+00);
  const float plow = float(0.02425), phigh = float(1.0 - 0.02425);
  p = fminf(fmaxf(p, float(1.0 / 33554432.0)),
            float(1.0 - 1.0 / 33554432.0));
  if (p < plow || p > phigh) {
    float q = p < plow ? p : 1.0f - p;
    float s = sqrtf(-2.0f * log_f32(q));
    float num = ((((c0 * s + c1) * s + c2) * s + c3) * s + c4) * s + c5;
    float den = (((d0 * s + d1) * s + d2) * s + d3) * s + 1.0f;
    return p < plow ? num / den : -(num / den);
  }
  float q = p - 0.5f;
  float r = q * q;
  float num = ((((a0 * r + a1) * r + a2) * r + a3) * r + a4) * r + a5;
  float den = ((((b0 * r + b1) * r + b2) * r + b3) * r + b4) * r + 1.0f;
  return num * q / den;
}

// Gamma(a, 1): Marsaglia-Tsang rounds on sites (site0, site0+1), the a < 1
// boost uniform on site0+2.
__device__ float gamma_mt(const Rng& rng, int site0, uint32_t fe, float a) {
  float boost = a < 1.0f ? 1.0f : 0.0f;
  float a_eff = a + boost;
  float d = a_eff - float(1.0 / 3.0);
  float c = 1.0f / sqrtf(9.0f * d);
  float v_acc = 1.0f;
  for (int t = 0; t < kMtRounds; ++t) {
    float x = normal_icdf(rng.uniform(site0, t, fe));
    float u = rng.uniform(site0 + 1, t, fe);
    float y = 1.0f + c * x;
    float v = y * (y * y);
    if (v > 0.0f &&
        log_f32(u) < 0.5f * x * x + d - d * v + d * log_f32(fmaxf(v, kTiny))) {
      v_acc = v;
      break;
    }
  }
  float sample = d * v_acc;
  float ub = rng.uniform(site0 + 2, 0, fe);
  float boosted = sample * exp_f32(log_f32(ub) / fmaxf(a, kTiny));
  float out = sample * (1.0f - boost) + boosted * boost;
  return fmaxf(out, 1e-30f);
}

}  // namespace basicrta
