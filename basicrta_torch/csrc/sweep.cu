// Fused collapsed-Gibbs sweep kernels for Hopper (sm_90a).
//
// What they replace:
//   basicrta_sweep_stats -> K1, basicrta_tpu/sampler/pallas_sweep.py
//                           sweep_stats (_sweep_stats_kernel, _suff_stats)
//   basicrta_segment     -> K2, pallas_sweep.py segment_pallas with pack=1
//                           (_segment_kernel, _conjugate_in_kernel,
//                           _gamma_mt with early exit, btrd_nat_h4 BTRS)
//   basicrta_segment_packed -> K3, pallas_sweep.py _segment_pallas_packed
//                           (_suff_stats_packed, _suffix_sums_packed,
//                           _segment_masks): pack logical lanes in one
//                           128-column physical lane, uniform or mixed
//                           widths (a slot-id row per physical lane)
//
// The samplers, the RNG and the precise f32 ops are in samplers.cuh.
//
// What bounds them on this card: not memory. A lane's values and counts
// (8 bytes a column) are read once per sweep from L2/L1; the work is the
// transcendental and integer instruction throughput of the samplers (expf
// per column and component for the suffix sums; logf/sqrtf and the
// counter hash in every BTRS and gamma round; the 17- and 32-step
// inversion walks) plus one block-wide synchronisation and reduction per
// sweep, which serialises the conjugate draw between sweeps.
//
// What the design does about it:
//   * one thread block per lane (residue x chain), 128 threads, thread t
//     owns column t of every 128-column row. Columns are sorted by
//     multiplicity, so every thread gets the same mix of expensive head-
//     tier and cheap singleton columns.
//   * the whole n_blocks*g sweep loop runs inside the block with (w, r) in
//     shared memory: one launch per segment, nothing in device memory
//     between sweeps except the thinned samples.
//   * each column's conditional-binomial chain over the K-1 stages is
//     independent of the other columns', so a thread runs its column
//     through all stages without synchronising, keeping its own partial
//     N_k and T_k; one deterministic warp-shuffle + shared-memory reduction
//     of the 2K partials per sweep (fixed order, so a chain is reproducible
//     and resumes exactly at any segment boundary).
//   * random numbers are the JAX package's counter hash of (seed, lane
//     group, call site, round, element id) with the reference's site
//     numbering: a draw that an element's branch does not take is simply
//     never computed, and rejection loops leave per thread as soon as the
//     element accepts (per-element results equal the tile-wide early exit).
//   * precision-amplified sites use the precise polynomial log/exp of
//     basicrta_tpu/ops/precise.py; everything else logf/expf/sqrtf
//     (never the fast intrinsics). Built with -fmad=false: contraction
//     moved the inverse-normal polynomial of the gamma draw by up to 1e-3
//     relative, so the kernel now does the plain version's arithmetic.
//   * K3 keeps K2's per-column body and one block per physical lane, so a
//     row's expensive binomial draws serve up to `pack` small residues;
//     only the statistics split per slot (see segment_packed_kernel).
//
// Entry points have a plain C interface (ctypes) and return
// cudaGetLastError() after the launch.

#include "samplers.cuh"

namespace {

using namespace basicrta;

// ----------------------------------------------------------- sweep body

struct Bucket {
  const float* values;  // (B, V) multiplicity-sorted
  const float* counts;
  int B, V, K, head_rows, small_rows, G;
};

// Call sites of one sweep, in the reference's trace order.
struct Sites {
  int single;   // singleton inverse-CDF uniform (if any singleton rows)
  int base;     // sites before stage 0
  int head;     // sites a head-tier stage takes
  int stage;    // sites per stage
  __device__ Sites(const Bucket& bk, bool h4) {
    bool has_single = bk.V / kLanes > bk.small_rows;
    single = 1;
    base = has_single ? 1 : 0;
    head = bk.head_rows > 0 ? (h4 ? 3 + 2 * kBtrsUnroll : 3) : 0;
    stage = head + (bk.small_rows > bk.head_rows ? 1 : 0);
  }
  __device__ int gamma(int K) const { return base + (K - 1) * stage + 1; }
};

// This thread's partial (N_k, T_k) over its columns of lane b.
template <bool kH4>
__device__ void suff_stats(const Bucket& bk, int b, const Rng& rng,
                           const Sites& sites, const float* wr,
                           const float* r, float* Np, float* Tp) {
  const int K = bk.K;
  const int col = threadIdx.x;
  const uint32_t g = uint32_t(b % bk.G);
  const int SL = bk.V / kLanes;
  for (int k = 0; k < K; ++k) {
    Np[k] = 0.0f;
    Tp[k] = 0.0f;
  }
  for (int row = 0; row < SL; ++row) {
    const size_t idx = size_t(b) * bk.V + size_t(row) * kLanes + col;
    const float cnt = bk.counts[idx];
    if (cnt == 0.0f) continue;  // contributes nothing in any tier
    const float x = bk.values[idx];
    float S[kKMax + 1];
    float zsum = 0.0f;
    for (int k = K - 1; k >= 0; --k) {
      zsum = zsum + wr[k] * expf(-r[k] * x);
      S[k] = zsum;
    }
    if (row >= bk.small_rows) {
      // singleton tier: category k iff S_k > u S_0 >= S_{k+1}
      uint32_t fe = fmix(elem_id(row - bk.small_rows, g, col));
      float thresh = rng.uniform(sites.single, 0, fe) * S[0];
      int cat = K - 1;
      for (int k = 0; k < K - 1; ++k) {
        if (!(S[k + 1] > thresh)) {
          cat = k;
          break;
        }
      }
      Np[cat] += cnt;
      Tp[cat] += x * cnt;
      continue;
    }
    const bool head = row < bk.head_rows;
    const uint32_t fe =
        fmix(elem_id(head ? row : row - bk.head_rows, g, col));
    float rem = cnt;
    for (int k = 0; k < K - 1 && rem > 0.0f; ++k) {
      float pcond = fminf(fmaxf((S[k] - S[k + 1]) / fmaxf(S[k], kTiny),
                                0.0f), 1.0f);
      int stage_site = sites.base + k * sites.stage;
      float draw;
      if (head) {
        draw = binom_full<kH4>(rng, stage_site, fe, rem, pcond);
      } else {
        float u = rng.uniform(stage_site + sites.head + 1, 0, fe);
        draw = binom_inversion<true>(u, rem, pcond, kInvSmall);
      }
      Np[k] += draw;
      Tp[k] += x * draw;
      rem -= draw;
    }
    Np[K - 1] += rem;
    Tp[K - 1] += x * rem;
  }
}

// Block sum of the 2K partials in a fixed order: warp shuffles, then the
// warps' sums in warp order. Result in tot[0..2K) (N then T).
__device__ void block_reduce(const float* Np, const float* Tp, int K,
                             float* red, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k) {
    float n = Np[k], t = Tp[k];
    for (int off = 16; off > 0; off >>= 1) {
      n += __shfl_down_sync(0xFFFFFFFFu, n, off);
      t += __shfl_down_sync(0xFFFFFFFFu, t, off);
    }
    if (lane == 0) {
      red[k * kWarps + warp] = n;
      red[(K + k) * kWarps + warp] = t;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * K) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x * kWarps + w];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// shared memory: w, r, wr (K each), red (2K * kWarps), tot (2K), g2 (2K)
__host__ __device__ inline int smem_floats(int K) {
  return 3 * K + 2 * K * kWarps + 4 * K;
}

__global__ void __launch_bounds__(kLanes)
sweep_stats_kernel(Bucket bk, const float* w0, const float* r0, float* ns,
                   float* ts, int seed) {
  extern __shared__ float sm[];
  const int K = bk.K, b = blockIdx.x, tid = threadIdx.x;
  float *w = sm, *r = w + K, *wr = r + K, *red = wr + K,
        *tot = red + 2 * K * kWarps;
  if (tid < K) {
    w[tid] = w0[b * K + tid];
    r[tid] = r0[b * K + tid];
    wr[tid] = w[tid] * r[tid];
  }
  __syncthreads();
  const Rng rng = make_rng(uint32_t(seed), uint32_t(b / bk.G));
  const Sites sites(bk, false);
  float Np[kKMax], Tp[kKMax];
  suff_stats<false>(bk, b, rng, sites, wr, r, Np, Tp);
  block_reduce(Np, Tp, K, red, tot);
  if (tid < K) {
    ns[b * K + tid] = tot[tid];
    ts[b * K + tid] = tot[K + tid];
  }
}

__global__ void __launch_bounds__(kLanes)
segment_kernel(Bucket bk, const float* w0, const float* r0, float* W,
               float* R, float* wf, float* rf, int seed, int offset, int g,
               int n_blocks, float alpha, float ga, float gb) {
  extern __shared__ float sm[];
  const int K = bk.K, b = blockIdx.x, tid = threadIdx.x;
  float *w = sm, *r = w + K, *wr = r + K, *red = wr + K,
        *tot = red + 2 * K * kWarps, *g2 = tot + 2 * K;
  if (tid < K) {
    w[tid] = w0[b * K + tid];
    r[tid] = r0[b * K + tid];
  }
  const Sites sites(bk, true);
  const uint32_t lane = uint32_t(b / bk.G), gi = uint32_t(b % bk.G);
  float Np[kKMax], Tp[kKMax];
  const int n_sweeps = n_blocks * g;
  for (int i = 0; i < n_sweeps; ++i) {
    // reseed per absolute sweep: exact resume at any segment boundary
    const uint32_t seed_sweep =
        uint32_t(seed) * 2654435761u + uint32_t(offset + i);
    const Rng rng = make_rng(seed_sweep, lane);
    if (tid < K) wr[tid] = w[tid] * r[tid];
    __syncthreads();
    suff_stats<true>(bk, b, rng, sites, wr, r, Np, Tp);
    block_reduce(Np, Tp, K, red, tot);
    if (tid < 2 * K) {
      // the (2, G, K) tile of the reference: row 0 weights, row 1 rates
      const int row = tid / K, k = tid % K;
      const float a = (row == 0 ? alpha : ga) + tot[k];
      g2[tid] = gamma_mt(rng, sites.gamma(K), fmix(elem_id(row, gi, k)), a);
    }
    __syncthreads();
    if (tid < K) {
      float s = 0.0f;
      for (int j = 0; j < K; ++j) s += g2[j];
      w[tid] = g2[tid] / s;
      r[tid] = g2[K + tid] / (gb + tot[K + tid]);
      if ((i + 1) % g == 0) {
        const size_t o = (size_t(b) * n_blocks + (i + 1) / g - 1) * K + tid;
        W[o] = w[tid];
        R[o] = r[tid];
      }
    }
    __syncthreads();
  }
  if (tid < K) {
    wf[b * K + tid] = w[tid];
    rf[b * K + tid] = r[tid];
  }
}

// ------------------------------------------------------- packed lanes (K3)

constexpr int kPartStride = kLanes + 1;  // padded rows: no bank conflicts

// shared memory: w, r, wr (pack*K each), tot (2*pack*K: N then T),
// g2 (2*pack*K), part (2K rows of kPartStride), slot ids (kLanes ints)
__host__ __device__ inline int packed_smem_floats(int K, int pack) {
  return 7 * pack * K + 2 * K * kPartStride + kLanes;
}

// One block per physical lane b, thread t owns column t. The lane holds
// `pack` logical lanes (slots), each with its own (w, r) chain; column t
// belongs to slot sid[t] (columns of no member carry slot 0 and count 0,
// so they add nothing). The state is slot-ordered: logical lane
// b * pack + s. Per sweep:
//   * the suffix sums and the binomial chain are K2's per-column code,
//     each thread reading its own slot's (w r, r) from shared memory;
//   * (N_k, T_k) per slot in a fixed order, no atomics: each thread's
//     row sums (its partials), then one thread per (N|T, slot, k) adds
//     that slot's columns in column order;
//   * the conjugate draw: 2 * pack * K Marsaglia-Tsang gammas looped over
//     the block's threads, element ids of the reference's (2, pack, G, K)
//     tile.
__global__ void __launch_bounds__(kLanes)
segment_packed_kernel(Bucket bk, int pack, const int* slot_ids,
                      const float* w0, const float* r0, float* W, float* R,
                      float* wf, float* rf, int seed, int offset, int g,
                      int n_blocks, float alpha, float ga, float gb) {
  extern __shared__ float sm[];
  const int K = bk.K, b = blockIdx.x, tid = threadIdx.x, PK = pack * K;
  float *w = sm, *r = w + PK, *wr = r + PK, *tot = wr + PK,
        *g2 = tot + 2 * PK, *part = g2 + 2 * PK;
  int* sid = reinterpret_cast<int*>(part + 2 * K * kPartStride);
  sid[tid] = slot_ids[size_t(b) * kLanes + tid];
  for (int j = tid; j < PK; j += kLanes) {
    w[j] = w0[size_t(b) * PK + j];
    r[j] = r0[size_t(b) * PK + j];
  }
  const int own = sid[tid];
  const Sites sites(bk, true);
  const uint32_t lane = uint32_t(b / bk.G), gi = uint32_t(b % bk.G);
  float Np[kKMax], Tp[kKMax];
  const int n_sweeps = n_blocks * g;
  for (int i = 0; i < n_sweeps; ++i) {
    const uint32_t seed_sweep =
        uint32_t(seed) * 2654435761u + uint32_t(offset + i);
    const Rng rng = make_rng(seed_sweep, lane);
    for (int j = tid; j < PK; j += kLanes) wr[j] = w[j] * r[j];
    __syncthreads();
    suff_stats<true>(bk, b, rng, sites, wr + own * K, r + own * K, Np, Tp);
    for (int k = 0; k < K; ++k) {
      part[k * kPartStride + tid] = Np[k];
      part[(K + k) * kPartStride + tid] = Tp[k];
    }
    __syncthreads();
    for (int j = tid; j < 2 * PK; j += kLanes) {
      // j = which * PK + s * K + k, which 0 for N and 1 for T
      const int which = j / PK, s = (j / K) % pack, k = j % K;
      const float* row = part + (which * K + k) * kPartStride;
      float acc = 0.0f;
      for (int c = 0; c < kLanes; ++c) {
        if (sid[c] == s) acc += row[c];
      }
      tot[j] = acc;
    }
    __syncthreads();
    for (int j = tid; j < 2 * PK; j += kLanes) {
      // the (2, pack, G, K) tile: row 0 weights, row 1 rates
      const int row = j / PK, s = (j / K) % pack, k = j % K;
      const float a = (row == 0 ? alpha : ga) + tot[s * K + k];
      const uint32_t fe =
          fmix(elem_id(uint32_t(row) * kElemMul + uint32_t(s), gi, k));
      g2[j] = gamma_mt(rng, sites.gamma(K), fe, a);
    }
    __syncthreads();
    for (int j = tid; j < PK; j += kLanes) {
      const int s = j / K;
      float sum = 0.0f;
      for (int q = 0; q < K; ++q) sum += g2[s * K + q];
      w[j] = g2[j] / sum;
      r[j] = g2[PK + j] / (gb + tot[PK + j]);
      if ((i + 1) % g == 0) {
        // logical lane b * pack + s, block (i + 1) / g - 1
        const size_t o =
            (size_t(b * pack + s) * n_blocks + (i + 1) / g - 1) * K + j % K;
        W[o] = w[j];
        R[o] = r[j];
      }
    }
    __syncthreads();
  }
  for (int j = tid; j < PK; j += kLanes) {
    wf[size_t(b) * PK + j] = w[j];
    rf[size_t(b) * PK + j] = r[j];
  }
}

}  // namespace

extern "C" int basicrta_sweep_stats(const float* w0, const float* r0,
                                    const float* values, const float* counts,
                                    float* ns, float* ts, int B, int V, int K,
                                    int head_rows, int small_rows, int G,
                                    int seed, void* stream) {
  Bucket bk{values, counts, B, V, K, head_rows, small_rows, G};
  size_t smem = sizeof(float) * smem_floats(K);
  sweep_stats_kernel<<<B, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      bk, w0, r0, ns, ts, seed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int basicrta_segment(const float* w0, const float* r0,
                                const float* values, const float* counts,
                                float* W, float* R, float* wf, float* rf,
                                int B, int V, int K, int head_rows,
                                int small_rows, int G, int seed, int offset,
                                int g, int n_blocks, float alpha, float ga,
                                float gb, void* stream) {
  Bucket bk{values, counts, B, V, K, head_rows, small_rows, G};
  size_t smem = sizeof(float) * smem_floats(K);
  segment_kernel<<<B, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      bk, w0, r0, W, R, wf, rf, seed, offset, g, n_blocks, alpha, ga, gb);
  return static_cast<int>(cudaGetLastError());
}

// Bph physical lanes of V = SL * 128 columns; state and outputs are
// slot-ordered over pack * Bph logical lanes.
extern "C" int basicrta_segment_packed(
    const float* w0, const float* r0, const float* values,
    const float* counts, const int* slot_ids, float* W, float* R, float* wf,
    float* rf, int Bph, int V, int K, int pack, int head_rows,
    int small_rows, int G, int seed, int offset, int g, int n_blocks,
    float alpha, float ga, float gb, void* stream) {
  Bucket bk{values, counts, Bph, V, K, head_rows, small_rows, G};
  size_t smem = sizeof(float) * packed_smem_floats(K, pack);
  segment_packed_kernel<<<Bph, kLanes, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      bk, pack, slot_ids, w0, r0, W, R, wf, rf, seed, offset, g, n_blocks,
      alpha, ga, gb);
  return static_cast<int>(cudaGetLastError());
}
