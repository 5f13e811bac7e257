// Host stand-in for <cuda_runtime.h>: enough of CUDA to compile the
// package's .cu sources with g++ and run a kernel's logic on the CPU
// (tests/test_torch_emulated.py). A block is a set of std::threads, run one
// block at a time; __syncthreads() is a std::barrier over the block, the
// warp primitives exchange through a per-warp array between two waits of
// the warp's own barrier, and the block has a buffer for its dynamic
// shared memory.
// Compile with -std=c++20 -ffp-contract=off -DBASICRTA_HOST_EMULATION.

#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__
#define __launch_bounds__(...)

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local emu_dim3 threadIdx, blockIdx, blockDim, gridDim;

struct float4 {
  float x, y, z, w;
};

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// A host "device" of two SMs that hold two blocks each: launches sized to
// the card's residency get a small grid of several blocks.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <typename Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, Kernel,
                                                          int, size_t) {
  *n = 2;
  return cudaSuccess;
}

inline unsigned long long atomicAdd(unsigned long long* at,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*at).fetch_add(v);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}

inline int __float_as_int(float x) {
  int i;
  std::memcpy(&i, &x, sizeof(i));
  return i;
}
inline float __int_as_float(int i) {
  float x;
  std::memcpy(&x, &i, sizeof(x));
  return x;
}

namespace emu {

struct Block {
  explicit Block(int threads)
      : all(threads), lanes(threads), smem(1 << 14) {
    for (int w = 0; w < (threads + 31) / 32; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(
          std::min(32, threads - 32 * w)));
    }
  }
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint32_t> lanes;  // one exchange word a thread
  std::vector<float> smem;      // the block's dynamic shared memory
};

inline Block* block = nullptr;

// every lane publishes `bits`, then reads lane `src`'s (its own when src
// lies outside the warp)
inline uint32_t exchange(uint32_t bits, int src) {
  const int tid = threadIdx.x, lane = tid & 31, base = tid - lane;
  std::barrier<>& bar = *block->warps[tid / 32];
  block->lanes[tid] = bits;
  bar.arrive_and_wait();
  const uint32_t got =
      src >= 0 && src < 32 ? block->lanes[base + src] : bits;
  bar.arrive_and_wait();
  return got;
}

}  // namespace emu

inline void __syncthreads() { emu::block->all.arrive_and_wait(); }

inline float __shfl_down_sync(unsigned, float v, int delta) {
  return __int_as_float(int(emu::exchange(
      uint32_t(__float_as_int(v)), int(threadIdx.x & 31) + delta)));
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return __int_as_float(int(emu::exchange(
      uint32_t(__float_as_int(v)), int(threadIdx.x & 31) ^ mask)));
}
inline float __shfl_sync(unsigned, float v, int src) {
  return __int_as_float(int(emu::exchange(uint32_t(__float_as_int(v)),
                                          src & 31)));
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int tid = threadIdx.x, base = tid - (tid & 31);
  std::barrier<>& bar = *emu::block->warps[tid / 32];
  emu::block->lanes[tid] = pred ? 1u : 0u;
  bar.arrive_and_wait();
  const int n = std::min(32, int(emu::block->lanes.size()) - base);
  unsigned mask = 0;
  for (int i = 0; i < n; ++i) {
    mask |= (emu::block->lanes[base + i] != 0u ? 1u : 0u) << i;
  }
  bar.arrive_and_wait();
  return mask;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  emu::block->warps[threadIdx.x / 32]->arrive_and_wait();
}
inline bool __any_sync(unsigned, bool pred) {
  bool any = false;
  for (int src = 0; src < 32; ++src) {
    any = emu::exchange(pred ? 1u : 0u, src) != 0u || any;
  }
  return any;
}

namespace basicrta {
// what samplers.cuh takes from the card's headers
inline float* dynamic_smem() { return emu::block->smem.data(); }
}  // namespace basicrta

// Run `kernel` block after block, each block's threads at once.
template <typename... Params, typename... Args>
int emulate_launch(void (*kernel)(Params...), int blocks, int threads,
                   Args... args) {
  for (int b = 0; b < blocks; ++b) {
    emu::Block block(threads);
    emu::block = &block;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([=] {
        threadIdx.x = unsigned(t);
        blockIdx.x = unsigned(b);
        blockDim.x = unsigned(threads);
        gridDim.x = unsigned(blocks);
        kernel(args...);
      });
    }
    for (std::thread& th : pool) th.join();
    emu::block = nullptr;
  }
  return 0;
}
