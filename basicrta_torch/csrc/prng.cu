// The device-PRNG probe (K5) for Hopper (sm_90a): raw draws of the sweep
// kernels' in-kernel samplers on (rows, 128) tiles, for the goodness-of-
// fit battery of basicrta_torch/scripts/device_prng.py.
//
// What it replaces: basicrta_tpu scripts/device_prng.py _call and
// draw_uniform / draw_binom / draw_gamma, tiny Pallas kernels that emit the
// same samplers' draws on a (256, 128) tile with lane id 1.
//
// The draws come from the very device code the sweep kernels run
// (samplers.cuh, built with the same flags), with the JAX package's call
// sites: the uniform on site 1; binom_full with its inversion uniform on
// site 1 and BTRS from site 2 (the lgamma form of K1 or the btrd_nat_h4
// form of K2); the early-exit Marsaglia-Tsang gamma of K2's conjugate draw
// on sites 1-3. Element id row * 0x27D4EB2F + col (the reference's two-axis
// iota combination); tile t of a launch draws with seed + t * seed_stride,
// so its bits are those of a one-tile launch at that seed.
//
// What bounds it: the bytes it writes (4 a draw), were its integer and
// branch work not in the way. The design keeps that work to what a draw
// needs:
// - A uniform is fmix(H ^ fe) with H = fmix(h0 ^ (site * C + t)) a
//   function of the tile's seed, the site and the round alone: each warp
//   computes the (site, t) hashes a sampler can take once per tile, a lane
//   an entry, into shared memory, and fe once per element.
// - n, p and a are launch-uniform: BTRS's and the gamma's setup run once a
//   thread, into registers, and the gamma's a < 1 boost only in a launch
//   that needs it.
// - The uniform kernel walks the tiles at a fixed (row, 4 columns), so fe
//   is computed once a thread, and stores 16 bytes a thread.
// - The rejection samplers run one persistent warp per slice of the
//   flattened (tile, element) range. A lane carries one element and its
//   round index; when the element is done the lane takes the next, so a
//   warp loops until its slice is done, not until its slowest lane
//   accepts. A BTRS round the squeeze leaves open is queued in the warp's
//   shared memory and its slow test runs 32 at a time, by lanes that are
//   free; a rejection is taken up by the lane that tested it at the next
//   round. Each element runs the same rounds on the same hashes as
//   binom_full / gamma_mt, so its bits are theirs.
//
// -DBASICRTA_PRNG_STATS adds basicrta_prng_draws_stats, the same launch
// with counters (lane-round slots issued, lane-rounds worked, slow-test
// slots and slow tests) and a per-element trace (rounds, slow-test rounds)
// from which device_prng.py counts the one-thread-per-element layout.

#include "samplers.cuh"

namespace {

using namespace basicrta;

enum Kind { kUniform = 0, kBinomLgamma = 1, kBinomH4 = 2, kGammaEarly = 3 };
enum Counter {
  kLaneSlots,
  kLaneRounds,
  kSlowSlots,
  kSlowTests,
  kWarpCycles,   // clock64() from a warp's start to its end
  kRoundCycles,  // ... in refills and rounds
  kDrainCycles,  // ... in queued slow tests
  kCounters
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// The slow-test queue holds fewer than 32 entries when a round starts: a
// drain takes min(free lanes, entries), and every lane that queued is
// free. So a round leaves at most 31 + 32 queued.
constexpr int kQueueCap = 64;
static_assert(kQueueCap >= 31 + 32, "a round can overfill the queue");
// a warp's shared words: the site-hash table, then the slow-test queue's
// element, round, k, us, v and trace fields
constexpr int kWarpWords = 32 + 6 * kQueueCap;
constexpr int kBlockWords = kWarps * kWarpWords;
constexpr int kMinWarpDraws = 256;  // the least a warp's slice is given

template <class T>
__host__ __device__ __forceinline__ T tmin(T x, T y) {
  return x < y ? x : y;
}
template <class T>
__host__ __device__ __forceinline__ T tmax(T x, T y) {
  return x < y ? y : x;
}

__device__ __forceinline__ uint32_t tile_h0(uint32_t seed, uint32_t stride,
                                            uint32_t tile) {
  return make_rng(seed + tile * stride, 1u).h0;
}

__device__ __forceinline__ uint32_t elem_hash(int idx) {
  const uint32_t i = uint32_t(idx);
  return fmix(i / kLanes * kElemMul + i % kLanes);
}

// The uniform source of a tile: its site hashes in a table, one entry a
// (site, t) the sampler can take. Binomials: (1, 0) the inversion
// uniform, then round t's BTRS pair at 1 + 2t and 2 + 2t (first sites
// even, second odd in both forms). Gamma: round t's pair at 2t and
// 2t + 1, the boost uniform (3, 0) at 16.
template <int kKind>
struct TileRng {
  const uint32_t* H;
  __device__ __forceinline__ static int slot(int site, int t) {
    if (kKind == kGammaEarly) {
      return site == 3 ? 2 * kMtRounds : 2 * t + site - 1;
    }
    return site == 1 ? 0 : 1 + 2 * t + (site & 1);
  }
  // the (site, t) of table entry j (j < 32; entries past the sampler's
  // last are never read)
  __device__ __forceinline__ static void entry(int j, int& site, int& t) {
    if (kKind == kGammaEarly) {
      site = j >= 2 * kMtRounds ? 3 : 1 + (j & 1);
      t = j >= 2 * kMtRounds ? 0 : j >> 1;
    } else if (j == 0) {
      site = 1;
      t = 0;
    } else {
      t = (j - 1) >> 1;
      site = btrs_site<kKind == kBinomH4>(2, t) + ((j - 1) & 1);
    }
  }
  __device__ __forceinline__ float uniform(int site, int t,
                                           uint32_t fe) const {
    return hash_uniform(H[slot(site, t)], fe);
  }
};

// Fill the warp's table for `tile` (every lane of the warp calls it).
template <int kKind>
__device__ __forceinline__ void fill_table(uint32_t* H, uint32_t h0) {
  const int lane = threadIdx.x & 31;
  int site, t;
  TileRng<kKind>::entry(lane, site, t);
  __syncwarp();
  H[lane] = site_hash(h0, site, t);
  __syncwarp();
}

// Per-warp counters of a stats build, summed into the launch's at the end
// (lane 0's cycles stand for the warp's).
struct Stats {
  unsigned long long c[kCounters] = {};
  long long since = 0;
  __device__ __forceinline__ void start() { since = clock64(); }
  __device__ __forceinline__ void lap(int counter) {
    const long long now = clock64();
    c[counter] += now - since;
    since = now;
  }
  __device__ __forceinline__ void round(unsigned busy) {
    c[kLaneSlots] += 32;
    c[kLaneRounds] += __popc(busy);
  }
  __device__ __forceinline__ void slow(unsigned lanes) {
    if (lanes) {
      c[kSlowSlots] += 32;
      c[kSlowTests] += __popc(lanes);
    }
  }
};

// The warp's slow-test queue in shared memory; the trace field only in a
// stats build.
template <bool kStats>
struct SlowQueue {
  uint32_t* w;
  __device__ __forceinline__ void push(int i, int e, int t, float k,
                                       float us, float v, uint32_t tr) {
    w[i] = uint32_t(e);
    w[kQueueCap + i] = uint32_t(t);
    w[2 * kQueueCap + i] = __float_as_int(k);
    w[3 * kQueueCap + i] = __float_as_int(us);
    w[4 * kQueueCap + i] = __float_as_int(v);
    if (kStats) w[5 * kQueueCap + i] = tr;
  }
  __device__ __forceinline__ void pop(int i, int& e, int& t, float& k,
                                      float& us, float& v,
                                      uint32_t& tr) const {
    e = int(w[i]);
    t = int(w[kQueueCap + i]);
    k = __int_as_float(int(w[2 * kQueueCap + i]));
    us = __int_as_float(int(w[3 * kQueueCap + i]));
    v = __int_as_float(int(w[4 * kQueueCap + i]));
    tr = kStats ? w[5 * kQueueCap + i] : 0u;
  }
};

// The slow-test rounds of an element, one bit a round, beside its round
// count: the trace word of a stats build.
__device__ __forceinline__ uint32_t trace_word(int rounds, uint32_t slow) {
  return uint32_t(rounds) | (slow << 8);
}

// BTRS draws of in-tile elements [lo, hi) by one warp: the lane refill and
// the deferred slow test (see the top of the file). `flip` and the clamp
// finish binom_full.
template <bool kH4, bool kStats>
__device__ void btrs_slice(float* out, uint32_t* trace, const uint32_t* H,
                           SlowQueue<kStats> q, int lo, int hi,
                           const BtrsSetup& s,
                           float n, bool flip, Stats& st) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const TileRng<kH4 ? kBinomH4 : kBinomLgamma> rng{H};
  auto finish = [&](int e, float k, int rounds, uint32_t slow) {
    float m = flip ? n - k : k;
    out[e] = fminf(fmaxf(m, 0.0f), n);
    if (kStats) trace[e] = trace_word(rounds, slow);
  };
  int next = lo, count = 0;  // warp-uniform
  int e = -1, t = 0;
  uint32_t fe = 0, slow = 0;
  for (;;) {
    const unsigned idle = __ballot_sync(kFull, e < 0);
    if (e < 0) {
      const int i = next + __popc(idle & below);
      if (i < hi) {
        e = i;
        t = 0;
        slow = 0;
        fe = elem_hash(i);
      }
    }
    next = tmin(next + __popc(idle), hi);
    const unsigned busy = __ballot_sync(kFull, e >= 0);
    if (busy == 0u && count == 0) break;
    if (kStats) st.start();
    if (busy) {
      if (kStats) st.round(busy);
      int step = kBtrsRetry;
      float k = 0.0f, us = 0.0f, v = 0.0f;
      if (e >= 0) {
        const int site = btrs_site<kH4>(2, t);
        const float u = rng.uniform(site, t, fe) - 0.5f;
        v = rng.uniform(site + 1, t, fe);
        step = btrs_squeeze(s, n, u, v, k, us);
      }
      const unsigned open = __ballot_sync(kFull, step == kBtrsSlow);
      if (step == kBtrsSlow) {
        slow |= 1u << t;
        q.push(count + __popc(open & below), e, t, k, us, v, slow);
        e = -1;
      }
      count += __popc(open);
      if (e >= 0) {
        if (step == kBtrsAccept) {
          finish(e, k, t + 1, slow);
          e = -1;
        } else if (++t == kBtrsRounds) {
          finish(e, s.m, kBtrsRounds, slow);
          e = -1;
        }
      }
      __syncwarp();
    }
    if (kStats) st.lap(kRoundCycles);
    // free lanes run queued slow tests: when 32 are waiting, or when the
    // slice has no fresh element left
    if (count >= 32 || (next >= hi && count > 0)) {
      const unsigned free = __ballot_sync(kFull, e < 0);
      const int rank = __popc(free & below);
      const int take = tmin(__popc(free), count);
      if (kStats) st.slow(__ballot_sync(kFull, e < 0 && rank < take));
      if (e < 0 && rank < take) {
        int qe, qt;
        float k, us, v;
        uint32_t tr;
        q.pop(count - 1 - rank, qe, qt, k, us, v, tr);
        if (btrs_slow<kH4>(s, n, k, us, v)) {
          finish(qe, k, qt + 1, tr);
        } else if (qt + 1 == kBtrsRounds) {
          finish(qe, s.m, kBtrsRounds, tr);
        } else {
          e = qe;
          t = qt + 1;
          slow = tr;
          fe = elem_hash(qe);
        }
      }
      count -= take;
      __syncwarp();
      if (kStats) st.lap(kDrainCycles);
    }
  }
}

// Early-exit gamma draws of in-tile elements [lo, hi) by one warp, with
// the lane refill.
template <bool kStats>
__device__ void gamma_slice(float* out, uint32_t* trace, const uint32_t* H,
                            int lo, int hi, const GammaSetup& g, float a,
                            Stats& st) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const TileRng<kGammaEarly> rng{H};
  int next = lo;
  int e = -1, t = 0;
  uint32_t fe = 0;
  for (;;) {
    const unsigned idle = __ballot_sync(kFull, e < 0);
    if (e < 0) {
      const int i = next + __popc(idle & below);
      if (i < hi) {
        e = i;
        t = 0;
        fe = elem_hash(i);
      }
    }
    next = tmin(next + __popc(idle), hi);
    const unsigned busy = __ballot_sync(kFull, e >= 0);
    if (busy == 0u) break;
    if (kStats) {
      st.round(busy);
      st.start();
    }
    if (e >= 0) {
      float v;
      const bool accept = gamma_round(g, rng.uniform(1, t, fe),
                                      rng.uniform(2, t, fe), v);
      if (accept || ++t == kMtRounds) {
        const float sample = g.d * (accept ? v : 1.0f);
        out[e] = g.boost > 0.0f
                     ? gamma_finish(g, sample, rng.uniform(3, 0, fe), a)
                     : fmaxf(sample, 1e-30f);
        if (kStats) trace[e] = trace_word(accept ? t + 1 : kMtRounds, 0u);
        e = -1;
      }
    }
    if (kStats) st.lap(kRoundCycles);
  }
}

// The rejection samplers: a persistent warp per slice of the flattened
// (tile, element) range, table refilled at each tile it enters.
template <int kKind, bool kStats>
__global__ void __launch_bounds__(kThreads)
reject_kernel(float* out, uint32_t* trace, unsigned long long* counters,
              int rows, int tiles, uint32_t seed, uint32_t stride, float n,
              float p, float a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  uint32_t* w = reinterpret_cast<uint32_t*>(dynamic_smem()) +
                warp * kWarpWords;
  uint32_t* H = w;
  const SlowQueue<kStats> q{w + 32};
  const size_t per_tile = size_t(rows) * kLanes;
  const size_t total = per_tile * size_t(tiles);
  const size_t W = size_t(gridDim.x) * kWarps;
  const size_t gw = size_t(blockIdx.x) * kWarps + warp;
  const size_t base = total / W, extra = total % W;
  size_t lo = base * gw + tmin(gw, extra);
  const size_t hi = lo + base + (gw < extra ? 1 : 0);

  // binom_full's launch-uniform choices
  constexpr bool kH4 = kKind == kBinomH4;
  const float pc = fminf(fmaxf(p, 0.0f), 1.0f);
  const bool flip = pc > 0.5f;
  const float pe = flip ? 1.0f - pc : pc;
  const bool btrs = !(pc <= 0.0f || n <= 0.0f) && !(pc >= 1.0f) &&
                    !(n * pe <= 10.0f);
  const BtrsSetup bs = btrs_setup<kH4>(n, btrs ? pe : 0.25f);
  const GammaSetup gs = gamma_setup(a);
  Stats st;
  const long long born = kStats ? clock64() : 0;
  while (lo < hi) {
    const size_t tile = lo / per_tile;
    const size_t end = tmin(hi, (tile + 1) * per_tile);
    const int e0 = int(lo - tile * per_tile), e1 = int(end - tile * per_tile);
    float* o = out + tile * per_tile;
    uint32_t* tr = kStats ? trace + tile * per_tile : nullptr;
    fill_table<kKind>(H, tile_h0(seed, stride, uint32_t(tile)));
    if (kKind == kGammaEarly) {
      gamma_slice<kStats>(o, tr, H, e0, e1, gs, a, st);
    } else if (btrs) {
      btrs_slice<kH4, kStats>(o, tr, H, q, e0, e1, bs, n, flip, st);
    } else {
      // inversion or a degenerate p: one pass, no rejection loop
      const TileRng<kKind> rng{H};
      for (int i = e0 + lane; i < e1; i += 32) {
        o[i] = binom_full<kH4>(rng, 0, elem_hash(i), n, p);
        if (kStats) tr[i] = trace_word(1, 0u);
      }
      if (kStats) {
        st.c[kLaneSlots] += 32ull * ((e1 - e0 + 31) / 32);
        st.c[kLaneRounds] += e1 - e0;
      }
    }
    lo = end;
  }
  if (kStats && lane == 0) {
    st.c[kWarpCycles] = clock64() - born;
    for (int c = 0; c < kCounters; ++c) atomicAdd(counters + c, st.c[c]);
  }
}

// The uniform: thread (position, group) walks tiles group, group + groups,
// ... at one (row, 4 columns) of the tile.
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
uniform_kernel(float* out, uint32_t* trace, unsigned long long* counters,
               int rows, int tiles, uint32_t seed, uint32_t stride) {
  const int per_tile = rows * (kLanes / 4);
  const int blocks_x = (per_tile + kThreads - 1) / kThreads;
  const int groups = gridDim.x / blocks_x;
  const int pos = int(blockIdx.x) % blocks_x * kThreads + threadIdx.x;
  const int group = int(blockIdx.x) / blocks_x;
  if (pos >= per_tile) return;
  const uint32_t row = pos / (kLanes / 4), col = pos % (kLanes / 4) * 4;
  uint32_t fe[4];
  for (int j = 0; j < 4; ++j) fe[j] = fmix(row * kElemMul + col + j);
  unsigned long long done = 0;
  for (int tile = group; tile < tiles; tile += groups) {
    const uint32_t h = site_hash(tile_h0(seed, stride, uint32_t(tile)), 1, 0);
    float4 x;
    x.x = hash_uniform(h, fe[0]);
    x.y = hash_uniform(h, fe[1]);
    x.z = hash_uniform(h, fe[2]);
    x.w = hash_uniform(h, fe[3]);
    const size_t at = size_t(tile) * per_tile + pos;
    reinterpret_cast<float4*>(out)[at] = x;
    if (kStats) {
      for (int j = 0; j < 4; ++j) trace[4 * at + j] = trace_word(1, 0u);
    }
    done += 4;
  }
  if (kStats) {
    atomicAdd(counters + kLaneSlots, done);
    atomicAdd(counters + kLaneRounds, done);
  }
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int blocks, size_t smem, void* stream,
           Args... args) {
#ifdef BASICRTA_HOST_EMULATION
  return emulate_launch(kernel, blocks, kThreads, args...);
#else
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
#endif
}

// Blocks of `kernel` the card holds at once.
template <typename... Params>
int resident_blocks(void (*kernel)(Params...), size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  return tmax(1, sms * per_sm);
}

template <bool kStats>
int draws(float* out, uint32_t* trace, unsigned long long* counters,
          int rows, int tiles, int kind, int seed, int seed_stride, float n,
          float p, float a, void* stream) {
  if (kind < kUniform || kind > kGammaEarly || rows < 1 || tiles < 1 ||
      size_t(rows) * kLanes > size_t(0x7FFFFFFF) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t s = uint32_t(seed), stride = uint32_t(seed_stride);
  if (kind == kUniform) {
    auto* k = uniform_kernel<kStats>;
    const int blocks_x = (rows * (kLanes / 4) + kThreads - 1) / kThreads;
    const int groups = tmin(tiles, tmax(1, resident_blocks(k, 0) / blocks_x));
    return launch(k, blocks_x * groups, 0, stream, out, trace, counters,
                  rows, tiles, s, stride);
  }
  auto* k = kind == kBinomLgamma ? reject_kernel<kBinomLgamma, kStats>
            : kind == kBinomH4   ? reject_kernel<kBinomH4, kStats>
                                 : reject_kernel<kGammaEarly, kStats>;
  const size_t smem = size_t(kBlockWords) * sizeof(uint32_t);
  const size_t total = size_t(rows) * kLanes * size_t(tiles);
  const size_t per_block = size_t(kWarps) * kMinWarpDraws;
  const size_t want = (total + per_block - 1) / per_block;
  const int blocks = int(tmin(size_t(resident_blocks(k, smem)), want));
  return launch(k, blocks, smem, stream, out, trace, counters, rows, tiles,
                s, stride, n, p, a);
}

}  // namespace

extern "C" int basicrta_prng_draws(float* out, int rows, int tiles, int kind,
                                   int seed, int seed_stride, float n, float p,
                                   float a, void* stream) {
  return draws<false>(out, nullptr, nullptr, rows, tiles, kind, seed,
                      seed_stride, n, p, a, stream);
}

#ifdef BASICRTA_PRNG_STATS
// The same launch with counters[kCounters] (added to) and trace[rows * 128
// * tiles] (rounds | slow-test rounds << 8 for each element).
extern "C" int basicrta_prng_draws_stats(float* out, uint32_t* trace,
                                         unsigned long long* counters,
                                         int rows, int tiles, int kind,
                                         int seed, int seed_stride, float n,
                                         float p, float a, void* stream) {
  return draws<true>(out, trace, counters, rows, tiles, kind, seed,
                     seed_stride, n, p, a, stream);
}
#endif
