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
//                           widths (one contiguous column range per slot)
//   the `tree` flag of all three -> K4, pallas_sweep.py _suff_stats_tree
//                           with _tiered_binom: the multinomial by binary
//                           splitting, log2(Kp) levels of node draws
//                           instead of the chain's K-1 stages
//
// The samplers, the RNG and the precise f32 ops are in samplers.cuh.
//
// What bounds them on this card: not memory. A lane's values and counts
// (8 bytes a column) are read once per sweep from L2/L1; the work is the
// latency of one column's chain of up to K-1 dependent binomial draws
// (expf per component for the suffix sums; logf/sqrtf and the counter hash
// in every BTRS round; the 17- and 32-step inversion walks with a division
// a step), and the conjugate draw that has to wait for every column of the
// lane before the next sweep can start.
//
// What the design does about it:
//   * one thread block per lane (residue x chain, or physical lane), and a
//     thread per column: the block has 128 threads for each of the lane's
//     128-column rows, up to 1,024 (512 for the tree forms); a lane with
//     more rows takes them in turns of the block's rows, to and fro, so
//     that the threads of the first rows get the last. A warp holds 32
//     neighbouring columns of one row, so it runs one tier's sampler; the
//     head rows are the first rows and their warps set the sweep's time
//     while the singleton warps retire early.
//   * the whole n_blocks*g sweep loop runs inside the block with (w, r) in
//     shared memory: one launch per segment, nothing in device memory
//     between sweeps except the thinned samples.
//   * a column's draw of stage k goes straight into the reduction: a
//     segmented warp shuffle sums it over each run of neighbouring columns
//     that one slot owns (the whole warp for K1/K2), and the run's first
//     lane puts the sum into its own cell of shared memory. No per-thread
//     (N_k, T_k) arrays, no atomics; the order of every sum depends on the
//     layout alone, so a chain is reproducible and resumes exactly at any
//     segment boundary, and N_k (whole numbers below 2^24) is exact.
//   * two barriers a sweep. After the first, one thread per (weights |
//     rates, slot, component) adds its slot's cells in a fixed order,
//     draws its Marsaglia-Tsang gamma (2 * pack * K draws in one round over
//     the block), and the K threads of a slot sum the Dirichlet normaliser
//     by a butterfly shuffle; they write the new (w, r) and, every g
//     sweeps, the thinned sample. The second barrier publishes the state.
//   * random numbers are the JAX package's counter hash of (seed, lane
//     group, call site, round, element id) with the reference's site
//     numbering; element ids are functions of (tier row, group, column),
//     not of the thread that draws. A draw that an element's branch does
//     not take is never computed, and rejection loops leave per thread as
//     soon as the element accepts.
//   * precision-amplified sites use the precise polynomial log/exp of
//     basicrta_tpu/ops/precise.py; everything else logf/expf/sqrtf
//     (never the fast intrinsics). Built with -fmad=false: contraction
//     moved the inverse-normal polynomial of the gamma draw by up to 1e-3
//     relative, so the kernel does the plain version's arithmetic.
//   * K4 (the tree): a thread keeps its column's Kp node counts in one
//     array, splits each node (a, b) in place (left count at a, right at
//     (a + b) / 2), level by level, and hands its K leaves to the same
//     reduction. Each kernel is instantiated for both forms.
//
// Entry points have a plain C interface (ctypes), take the block's thread
// count from the caller (cuda_sweep.block_threads) and return
// cudaGetLastError() after the launch. -DBASICRTA_PHASES builds the
// clock64() stamps that scripts/sweep_phases.py reads.

#include "samplers.cuh"

namespace {

using namespace basicrta;

constexpr int kChainThreads = 1024;  // most threads of a block
constexpr int kTreeThreads = 512;    // ... of a tree form's

// ----------------------------------------------------------- sweep body

#ifdef BASICRTA_PHASES
// Per-thread cycle counts of a sweep's phases (scripts/sweep_phases.py):
// 0 state, 1 suffix sums, 2 head, 3 small, 4 singleton, 5 reduction and
// the wait for the block, 6 conjugate.
// A head warp's stages by the samplers its 32 columns took (0 none, 1
// CDF inversion, 2 BTRS, 3 both, one after the other): how many, and
// their cycles.
constexpr int kPhases = 7, kStageKinds = 4;
__device__ unsigned long long g_ph_sum[kPhases], g_ph_max[kPhases],
    g_ph_min[kPhases], g_stage_n[kStageKinds], g_stage_cycles[kStageKinds];
struct Phases {
  long long t, acc[kPhases], stage_n[kStageKinds], stage_cycles[kStageKinds];
  __device__ Phases() {
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
    for (int i = 0; i < kStageKinds; ++i) stage_n[i] = stage_cycles[i] = 0;
    t = clock64();
  }
  // the kind of the stage this warp is about to draw, binom_full's choice
  // of sampler per column
  __device__ int stage_kind(float n, float p) {
    const bool live = n > 0.0f && p > 0.0f && p < 1.0f;
    const bool inv = live && n * fminf(p, 1.0f - p) <= 10.0f;
    return (__any_sync(0xFFFFFFFFu, inv) ? 1 : 0) |
           (__any_sync(0xFFFFFFFFu, live && !inv) ? 2 : 0);
  }
  __device__ void stage(int kind, long long since) {
    stage_n[kind] += 1;
    stage_cycles[kind] += clock64() - since;
  }
  __device__ void mark(int i) {
    const long long now = clock64();
    acc[i] += now - t;
    t = now;
  }
  __device__ void flush() {
    for (int i = 0; i < kPhases; ++i) {
      atomicAdd(&g_ph_sum[i], (unsigned long long)acc[i]);
      atomicMax(&g_ph_max[i], (unsigned long long)acc[i]);
      atomicMin(&g_ph_min[i], (unsigned long long)acc[i]);
    }
    for (int i = 0; threadIdx.x % 32 == 0 && i < kStageKinds; ++i) {
      atomicAdd(&g_stage_n[i], (unsigned long long)stage_n[i]);
      atomicAdd(&g_stage_cycles[i], (unsigned long long)stage_cycles[i]);
    }
  }
};
#else
struct Phases {
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

struct Bucket {
  const float* values;  // (B, V) multiplicity-sorted
  const float* counts;
  int B, V, K, head_rows, small_rows, G;
};

// Call sites of one sweep, in the reference's trace order. The chain
// takes the singleton uniform, then K - 1 stages of (head tier sites,
// small tier site); the tree takes log2(Kp) levels of (head tier sites,
// small tier site, singleton site), only for the tiers the bucket has.
// The conjugate draw's sites follow the last stage or level.
struct Sites {
  int single;   // singleton inverse-CDF uniform of the chain
  int base;     // sites before stage or level 0
  int head;     // sites a head-tier stage or level takes
  int stage;    // sites per stage or level
  int steps;    // stages (K - 1) or levels (log2 Kp)
  int kp;       // the tree's component count, K rounded up to a power of 2
  __device__ Sites(const Bucket& bk, bool h4, bool tree) {
    const bool has_single = bk.V / kLanes > bk.small_rows;
    const bool has_small = bk.small_rows > bk.head_rows;
    single = 1;
    head = bk.head_rows > 0 ? (h4 ? 3 + 2 * kBtrsUnroll : 3) : 0;
    kp = 1;
    steps = 0;
    while (kp < bk.K) {
      kp *= 2;
      ++steps;
    }
    if (tree) {
      base = 0;
      stage = head + (has_small ? 1 : 0) + (has_single ? 1 : 0);
    } else {
      base = has_single ? 1 : 0;
      stage = head + (has_small ? 1 : 0);
      steps = bk.K - 1;
    }
  }
  __device__ int gamma() const { return base + steps * stage + 1; }
  // small tier and singleton sites of a tree level, after its head sites
  __device__ int small_site(int level) const {
    return base + level * stage + head + 1;
  }
};

// One column of one row through the tree: the Kp node counts split level
// by level in nd[] (node (a, b) keeps its left count at a and puts its
// right count at (a + b) / 2), so nd[0..K) end as the K leaves.
// Element ids fold the node index in before the tier's own row.
template <bool kH4>
__device__ void tree_column(const Bucket& bk, int row, uint32_t g, int col,
                            const Rng& rng, const Sites& sites,
                            const float* S, float cnt, float* nd) {
  const int K = bk.K, Kp = sites.kp;
  const int tier = row < bk.head_rows ? 0 : (row < bk.small_rows ? 1 : 2);
  const uint32_t trow = uint32_t(
      tier == 0 ? row : (tier == 1 ? row - bk.head_rows
                                   : row - bk.small_rows));
  const int single_site_off = bk.small_rows > bk.head_rows ? 1 : 0;
  nd[0] = cnt;
  int level = 0;
  for (int span = Kp; span > 1; span >>= 1, ++level) {
    for (int a = 0; a < Kp; a += span) {
      const int m = a + span / 2, e = a + span;
      const float n = nd[a];
      float left = 0.0f;
      if (n > 0.0f) {  // a node of count 0 draws 0 in every tier
        const float sa = a < K ? S[a] : 0.0f;
        const float sm = m < K ? S[m] : 0.0f;
        const float se = e < K ? S[e] : 0.0f;
        const float p =
            fminf(fmaxf((sa - sm) / fmaxf(sa - se, kTiny), 0.0f), 1.0f);
        const uint32_t fe =
            fmix(elem_id(uint32_t(a / span) * kElemMul + trow, g, col));
        float draw;
        if (tier == 0) {
          draw = binom_full<kH4>(rng, sites.base + level * sites.stage, fe,
                                 n, p);
        } else if (tier == 1) {
          draw = binom_inversion<true>(
              rng.uniform(sites.small_site(level), 0, fe), n, p, kInvSmall);
        } else {
          const float u =
              rng.uniform(sites.small_site(level) + single_site_off, 0, fe);
          draw = u < p ? n : 0.0f;
        }
        left = fminf(draw, n);
      }
      nd[m] = n - left;
      nd[a] = left;
    }
  }
}

// ------------------------------------------------- a lane over its block

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// Shared memory of a block: (w, r) of its pack * K chains, each column's
// slot and run ("piece": a maximal stretch of one warp's columns that one
// slot owns), each slot's first and last piece, and the reduction cells
// red[(N|T, k)][block row][piece], a padded stride apart.
struct Smem {
  float *w, *r, *red;
  int *slot, *piece, *first, *last;
  int pieces;   // cells per block row (an upper bound of the pieces)
  int stride;   // cells per (N|T, k), odd: no bank conflicts across k
};

__host__ __device__ inline int max_pieces(int pack, bool packed) {
  return packed ? 2 * pack + 4 : kLanes / 32;
}

__host__ __device__ inline int red_stride(int rows, int pieces) {
  return (rows * pieces) | 1;
}

__host__ inline size_t smem_bytes(int K, int pack, bool packed,
                                  int threads) {
  const int rows = threads / kLanes;
  return sizeof(float) * (2 * pack * K +
                          2 * K * red_stride(rows, max_pieces(pack, packed))) +
         sizeof(int) * (2 * kLanes + 2 * pack);
}

// This thread's column: its slot, its cell, and how the segmented shuffle
// of its warp treats it.
struct Column {
  int col, brow, slot, cell;
  unsigned same;   // bit j: lane + 2^j lies in this thread's piece
  bool first;      // first lane of its piece
};

// Carve the block's shared memory, derive the pieces from the slots'
// column ranges (`ranges` (pack, 2) of this lane: [start, end) per slot,
// empty slots 0, 0; nullptr for an unpacked lane), load (w, r).
__device__ Column block_setup(Smem& sm, int K, int pack, bool packed,
                              const int* ranges, const float* w0,
                              const float* r0) {
  const int tid = threadIdx.x, PK = pack * K;
  const int rows = blockDim.x / kLanes;
  sm.w = dynamic_smem();
  sm.r = sm.w + PK;
  sm.slot = reinterpret_cast<int*>(sm.r + PK);
  sm.piece = sm.slot + kLanes;
  sm.first = sm.piece + kLanes;
  sm.last = sm.first + pack;
  sm.red = reinterpret_cast<float*>(sm.last + pack);
  sm.pieces = max_pieces(pack, packed);
  sm.stride = red_stride(rows, sm.pieces);
  if (tid < kLanes) {
    // columns that no slot owns carry slot 0 and count 0
    int own = 0;
    for (int s = 0; ranges != nullptr && s < pack; ++s) {
      if (tid >= ranges[2 * s] && tid < ranges[2 * s + 1]) own = s;
    }
    sm.slot[tid] = own;
  }
  for (int j = tid; j < PK; j += blockDim.x) {
    sm.w[j] = w0[j];
    sm.r[j] = r0[j];
  }
  __syncthreads();
  if (tid < kLanes) {
    int p = 0;
    for (int c = 1; c <= tid; ++c) {
      if (c % 32 == 0 || sm.slot[c] != sm.slot[c - 1]) ++p;
    }
    sm.piece[tid] = p;
  }
  __syncthreads();
  if (tid < pack) {
    int a = 0, e = kLanes;
    if (ranges != nullptr) {
      a = ranges[2 * tid];
      e = ranges[2 * tid + 1];
    }
    // an empty slot has no piece: first > last
    sm.first[tid] = e > a ? sm.piece[a] : 1;
    sm.last[tid] = e > a ? sm.piece[e - 1] : 0;
  }
  Column c;
  c.col = tid % kLanes;
  c.brow = tid / kLanes;
  c.slot = sm.slot[c.col];
  c.cell = c.brow * sm.pieces + sm.piece[c.col];
  c.first = c.col % 32 == 0 || sm.piece[c.col] != sm.piece[c.col - 1];
  c.same = 0u;
  for (int j = 0; j < 5; ++j) {
    const int d = 1 << j;
    if (c.col % 32 + d < 32 && sm.piece[c.col + d] == sm.piece[c.col]) {
      c.same |= 1u << j;
    }
  }
  __syncthreads();
  return c;
}

// Sum (n, t) over each piece of the warp's columns, in an order the layout
// fixes, and let the piece's first lane put (or add) the sums into its
// cell. Every lane of the warp calls it.
__device__ __forceinline__ void piece_sum(const Column& c, float n, float t,
                                          float* cell, int t_off, bool add) {
  if (!__any_sync(kFullWarp, n != 0.0f)) {  // nothing drawn: t = x n = 0 too
    if (c.first && !add) {
      cell[0] = 0.0f;
      cell[t_off] = 0.0f;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float n2 = __shfl_down_sync(kFullWarp, n, 1 << j);
    const float t2 = __shfl_down_sync(kFullWarp, t, 1 << j);
    if ((c.same >> j) & 1u) {
      n += n2;
      t += t2;
    }
  }
  if (c.first) {
    cell[0] = add ? cell[0] + n : n;
    cell[t_off] = add ? cell[t_off] + t : t;
  }
}

// One row of lane b through one sweep's statistics: this thread's column
// by the chain or (kTree) the tree, every stage's draw summed over the
// pieces into red (added to it when `add`). The whole warp is in one row,
// hence in one tier.
template <bool kH4, bool kTree>
__device__ void row_stats(const Bucket& bk, int b, int row, const Column& c,
                          const Rng& rng, const Sites& sites, const Smem& sm,
                          bool add, Phases& ph) {
  const int K = bk.K;
  const uint32_t g = uint32_t(b % bk.G);
  const size_t idx = size_t(b) * bk.V + size_t(row) * kLanes + c.col;
  const float cnt = bk.counts[idx];
  float* cell = sm.red + c.cell;
  const int t_off = K * sm.stride;
  if (!__any_sync(kFullWarp, cnt > 0.0f)) {  // a warp of padding
    if (c.first && !add) {
      for (int k = 0; k < K; ++k) {
        cell[k * sm.stride] = 0.0f;
        cell[k * sm.stride + t_off] = 0.0f;
      }
    }
    return;
  }
  const float x = bk.values[idx];
  const float* w = sm.w + c.slot * K;
  const float* r = sm.r + c.slot * K;
  float S[kKMax + 1];
  float zsum = 0.0f;
  for (int k = K - 1; k >= 0; --k) {
    zsum = zsum + (w[k] * r[k]) * expf(-r[k] * x);
    S[k] = zsum;
  }
  ph.mark(1);
  if (kTree) {
    float nd[kKMax];
    tree_column<kH4>(bk, row, g, c.col, rng, sites, S, cnt, nd);
    for (int k = 0; k < K; ++k) {
      piece_sum(c, nd[k], x * nd[k], cell + k * sm.stride, t_off, add);
    }
    ph.mark(row < bk.head_rows ? 2 : (row < bk.small_rows ? 3 : 4));
    return;
  }
  if (row >= bk.small_rows) {
    // singleton tier: category k iff S_k > u S_0 >= S_{k+1}
    const uint32_t fe = fmix(elem_id(row - bk.small_rows, g, c.col));
    const float thresh = rng.uniform(sites.single, 0, fe) * S[0];
    bool open = cnt > 0.0f;
    for (int k = 0; k < K; ++k) {
      const bool hit = open && (k == K - 1 || !(S[k + 1] > thresh));
      piece_sum(c, hit ? cnt : 0.0f, hit ? x * cnt : 0.0f,
                cell + k * sm.stride, t_off, add);
      open = open && !hit;
    }
    ph.mark(4);
    return;
  }
  const bool head = row < bk.head_rows;
  const uint32_t fe = fmix(elem_id(head ? row : row - bk.head_rows, g, c.col));
  float rem = cnt;
  for (int k = 0; k < K - 1; ++k) {
    float draw = 0.0f;
#ifdef BASICRTA_PHASES
    const long long since = clock64();
    const int kind = !head ? 0 : ph.stage_kind(rem, fminf(fmaxf(
        (S[k] - S[k + 1]) / fmaxf(S[k], kTiny), 0.0f), 1.0f));
#endif
    if (rem > 0.0f) {
      const float pcond = fminf(
          fmaxf((S[k] - S[k + 1]) / fmaxf(S[k], kTiny), 0.0f), 1.0f);
      const int stage_site = sites.base + k * sites.stage;
      if (head) {
        draw = binom_full<kH4>(rng, stage_site, fe, rem, pcond);
      } else {
        const float u = rng.uniform(stage_site + sites.head + 1, 0, fe);
        draw = binom_inversion<true>(u, rem, pcond, kInvSmall);
      }
    }
    piece_sum(c, draw, x * draw, cell + k * sm.stride, t_off, add);
    rem -= draw;
#ifdef BASICRTA_PHASES
    if (head) ph.stage(kind, since);
#endif
  }
  piece_sum(c, rem, x * rem, cell + (K - 1) * sm.stride, t_off, add);
  ph.mark(head ? 2 : 3);
}

// Every row of the lane, a turn of the block's rows at a time: to and fro,
// so that the block rows with the lane's first rows (the head tier, the
// dearest) take its last (the cheapest) in the next turn, or none.
template <bool kH4, bool kTree>
__device__ __forceinline__ void lane_stats(const Bucket& bk, int b,
                                           const Column& c, const Rng& rng,
                                           const Sites& sites,
                                           const Smem& sm, Phases& ph) {
  const int SL = bk.V / kLanes, rows = blockDim.x / kLanes;
  for (int turn = 0; turn * rows < SL; ++turn) {
    const int row =
        turn * rows + (turn % 2 == 0 ? c.brow : rows - 1 - c.brow);
    if (row < SL) {
      row_stats<kH4, kTree>(bk, b, row, c, rng, sites, sm, turn != 0, ph);
    }
  }
}

// Slot s's total of cell row kk (k for N_k, K + k for T_k): its pieces of
// every block row, in order.
__device__ __forceinline__ float slot_total(const Smem& sm, int kk, int s) {
  const int rows = blockDim.x / kLanes;
  const float* cells = sm.red + kk * sm.stride;
  float acc = 0.0f;
  for (int br = 0; br < rows; ++br) {
    for (int p = sm.first[s]; p <= sm.last[s]; ++p) {
      acc += cells[br * sm.pieces + p];
    }
  }
  return acc;
}

template <bool kTree>
__global__ void __launch_bounds__(kTree ? kTreeThreads : kChainThreads)
sweep_stats_kernel(Bucket bk, const float* w0, const float* r0, float* ns,
                   float* ts, int seed) {
  const int K = bk.K, b = blockIdx.x, tid = threadIdx.x;
  Smem sm;
  const Column c = block_setup(sm, K, 1, false, nullptr, w0 + b * K,
                               r0 + b * K);
  const Rng rng = make_rng(uint32_t(seed), uint32_t(b / bk.G));
  const Sites sites(bk, false, kTree);
  Phases ph;
  lane_stats<false, kTree>(bk, b, c, rng, sites, sm, ph);
  __syncthreads();
  if (tid < 2 * K) {
    (tid < K ? ns : ts)[b * K + tid % K] = slot_total(sm, tid, 0);
  }
}

// K2 (kPacked false: one chain a lane, ranges nullptr, pack 1) and K3
// (pack chains a physical lane, slot-ordered state: logical lane
// b * pack + s) share the sweep loop; they differ in the element ids of
// the conjugate draw's tile, (2, G, K) against (2, pack, G, K).
template <bool kTree, bool kPacked>
__device__ void segment_loop(const Bucket& bk, int pack, const int* ranges,
                             const float* w0, const float* r0, float* W,
                             float* R, float* wf, float* rf, int seed,
                             int offset, int g, int n_blocks, float alpha,
                             float ga, float gb) {
  const int K = bk.K, b = blockIdx.x, tid = threadIdx.x, PK = pack * K;
  Smem sm;
  const Column c = block_setup(
      sm, K, pack, kPacked,
      ranges == nullptr ? nullptr : ranges + size_t(b) * 2 * pack,
      w0 + size_t(b) * PK, r0 + size_t(b) * PK);
  const Sites sites(bk, true, kTree);
  const uint32_t lane = uint32_t(b / bk.G), gi = uint32_t(b % bk.G);
  // the conjugate draw's threads: Kq (K rounded up to a power of two)
  // neighbouring lanes per (weights | rates, slot), so that a slot's
  // Dirichlet sum is a butterfly inside one warp
  int Kq = 1;
  while (Kq < K) Kq *= 2;
  const int draws = 2 * pack * Kq;
  const int n_sweeps = n_blocks * g;
  Phases ph;
  for (int i = 0; i < n_sweeps; ++i) {
    // reseed per absolute sweep: exact resume at any segment boundary
    const uint32_t seed_sweep =
        uint32_t(seed) * 2654435761u + uint32_t(offset + i);
    const Rng rng = make_rng(seed_sweep, lane);
    ph.mark(0);
    lane_stats<true, kTree>(bk, b, c, rng, sites, sm, ph);
    __syncthreads();  // the cells are complete
    ph.mark(5);
    for (int j = tid; (j & ~31) < draws; j += blockDim.x) {
      const int k = j % Kq, s = (j / Kq) % pack, row = j / (Kq * pack);
      const bool live = j < draws && k < K;
      float gam = 0.0f, t_k = 0.0f;
      if (live) {
        // row 0 weights, row 1 rates: both shapes take N_k
        const float n_k = slot_total(sm, k, s);
        if (row == 1) t_k = slot_total(sm, K + k, s);
        const uint32_t erow =
            kPacked ? uint32_t(row) * kElemMul + uint32_t(s) : uint32_t(row);
        gam = gamma_mt(rng, sites.gamma(), fmix(elem_id(erow, gi, k)),
                       (row == 0 ? alpha : ga) + n_k);
      }
      float sum = gam;
      for (int off = Kq / 2; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(kFullWarp, sum, off);
      }
      if (live) {
        const float val = row == 0 ? gam / sum : gam / (gb + t_k);
        (row == 0 ? sm.w : sm.r)[s * K + k] = val;
        if ((i + 1) % g == 0) {
          const size_t o =
              (size_t(b * pack + s) * n_blocks + (i + 1) / g - 1) * K + k;
          (row == 0 ? W : R)[o] = val;
        }
      }
    }
    __syncthreads();  // the new state is published
    ph.mark(6);
  }
  ph.flush();
  for (int j = tid; j < PK; j += blockDim.x) {
    wf[size_t(b) * PK + j] = sm.w[j];
    rf[size_t(b) * PK + j] = sm.r[j];
  }
}

template <bool kTree>
__global__ void __launch_bounds__(kTree ? kTreeThreads : kChainThreads)
segment_kernel(Bucket bk, const float* w0, const float* r0, float* W,
               float* R, float* wf, float* rf, int seed, int offset, int g,
               int n_blocks, float alpha, float ga, float gb) {
  segment_loop<kTree, false>(bk, 1, nullptr, w0, r0, W, R, wf, rf, seed,
                             offset, g, n_blocks, alpha, ga, gb);
}

template <bool kTree>
__global__ void __launch_bounds__(kTree ? kTreeThreads : kChainThreads)
segment_packed_kernel(Bucket bk, int pack, const int* ranges,
                      const float* w0, const float* r0, float* W, float* R,
                      float* wf, float* rf, int seed, int offset, int g,
                      int n_blocks, float alpha, float ga, float gb) {
  segment_loop<kTree, true>(bk, pack, ranges, w0, r0, W, R, wf, rf, seed,
                            offset, g, n_blocks, alpha, ga, gb);
}

// Launch `kernel` on `blocks` blocks of `threads` threads; the thread
// count must be whole rows within the instantiation's bound.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), bool tree, int blocks, int threads,
           size_t smem, void* stream, Args... args) {
  if (threads < kLanes || threads % kLanes != 0 ||
      threads > (tree ? kTreeThreads : kChainThreads)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
#ifdef BASICRTA_HOST_EMULATION
  return emulate_launch(kernel, blocks, threads, args...);
#else
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
#endif
}

}  // namespace

extern "C" int basicrta_sweep_stats(const float* w0, const float* r0,
                                    const float* values, const float* counts,
                                    float* ns, float* ts, int B, int V, int K,
                                    int head_rows, int small_rows, int G,
                                    int seed, int tree, int threads,
                                    void* stream) {
  Bucket bk{values, counts, B, V, K, head_rows, small_rows, G};
  return launch(tree ? sweep_stats_kernel<true> : sweep_stats_kernel<false>,
                tree, B, threads, smem_bytes(K, 1, false, threads), stream,
                bk, w0, r0, ns, ts, seed);
}

extern "C" int basicrta_segment(const float* w0, const float* r0,
                                const float* values, const float* counts,
                                float* W, float* R, float* wf, float* rf,
                                int B, int V, int K, int head_rows,
                                int small_rows, int G, int seed, int offset,
                                int g, int n_blocks, float alpha, float ga,
                                float gb, int tree, int threads,
                                void* stream) {
  Bucket bk{values, counts, B, V, K, head_rows, small_rows, G};
  return launch(tree ? segment_kernel<true> : segment_kernel<false>, tree, B,
                threads, smem_bytes(K, 1, false, threads), stream, bk, w0, r0,
                W, R, wf, rf, seed, offset, g, n_blocks, alpha, ga, gb);
}

// Bph physical lanes of V = SL * 128 columns; `ranges` (Bph, pack, 2) the
// slots' column ranges; state and outputs are slot-ordered over pack * Bph
// logical lanes.
extern "C" int basicrta_segment_packed(
    const float* w0, const float* r0, const float* values,
    const float* counts, const int* ranges, float* W, float* R, float* wf,
    float* rf, int Bph, int V, int K, int pack, int head_rows,
    int small_rows, int G, int seed, int offset, int g, int n_blocks,
    float alpha, float ga, float gb, int tree, int threads, void* stream) {
  Bucket bk{values, counts, Bph, V, K, head_rows, small_rows, G};
  return launch(
      tree ? segment_packed_kernel<true> : segment_packed_kernel<false>, tree,
      Bph, threads, smem_bytes(K, pack, true, threads), stream, bk, pack,
      ranges, w0, r0, W, R, wf, rf, seed, offset, g, n_blocks, alpha, ga, gb);
}

#ifdef BASICRTA_PHASES
// out: kPhases sums, maxima and minima of the threads' phase cycles, then
// kStageKinds counts and cycle sums of the head warps' stages, since the
// last reset
extern "C" int basicrta_phases(unsigned long long* out, int reset) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_ph_sum, sizeof(g_ph_sum));
  cudaMemcpyFromSymbol(out + kPhases, g_ph_max, sizeof(g_ph_max));
  cudaMemcpyFromSymbol(out + 2 * kPhases, g_ph_min, sizeof(g_ph_min));
  cudaMemcpyFromSymbol(out + 3 * kPhases, g_stage_n, sizeof(g_stage_n));
  cudaMemcpyFromSymbol(out + 3 * kPhases + kStageKinds, g_stage_cycles,
                       sizeof(g_stage_cycles));
  if (reset) {
    unsigned long long zero[kPhases], ones[kPhases];
    for (int i = 0; i < kPhases; ++i) {
      zero[i] = 0ull;
      ones[i] = ~0ull;
    }
    cudaMemcpyToSymbol(g_ph_sum, zero, sizeof(zero));
    cudaMemcpyToSymbol(g_ph_max, zero, sizeof(zero));
    cudaMemcpyToSymbol(g_ph_min, ones, sizeof(ones));
    cudaMemcpyToSymbol(g_stage_n, zero, sizeof(g_stage_n));
    cudaMemcpyToSymbol(g_stage_cycles, zero, sizeof(g_stage_cycles));
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
