// The transcendental ceiling of the card (K6), for Hopper (sm_90a).
//
// What it replaces: bench.py transcendental_ceiling (its Pallas kernel,
// bench.py:400-413), the roofline denominator of vpu_transcendental_util:
// 64 independent chains per element of a (256, 128) f32 tile, each
// advanced `iters` times by x <- exp(x * scale) (bench.py's scale is
// 1e-9), then summed in chain order into one (256, 128) f32 tile.
//
// What bounds it on this card: operations. Every step is one expf, whose
// exponential goes to the SFU (MUFU.EX2): 16 results per clock per SM,
// x 132 SMs x the SM clock (about 4.2e12/s at 1.98 GHz); expf adds its
// FP32 range reduction on top, which the FP32 pipes (128 per clock per
// SM) absorb. Bytes are nothing: 128 KiB written once.
//
// What the design does about it: each element's 64 chains are split over
// 4 threads of kPer = 16 chains each, held in registers, so every thread
// has 16 independent exps in flight per step and the card holds 131,072
// threads; the SFU and the issue of expf's ~9 instructions, not the
// latency of one chain, set the rate (16 measured best of 4..64 chains a
// thread). The chains' final values meet in shared memory and one thread
// sums them in chain order. It is built with the sweep kernels' own flags
// (-fmad=false, no fast-math intrinsics), so it measures the same expf the
// sweep kernels execute.
//
// The entry point has a plain C interface (ctypes) and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256, kCols = 128;   // the output tile
constexpr int kChains = 64;               // independent chains per element
constexpr int kPer = 16;                  // chains per thread
constexpr int kSplit = kChains / kPer;    // threads per element
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ceiling_kernel(float* out, int iters, float scale) {
  __shared__ float part[kThreads * kPer];
  const int t0 = (threadIdx.x % kSplit) * kPer;   // this thread's chains
  float x[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) x[t] = float(0.5 + 0.1 * double(t0 + t));
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < kPer; ++t) x[t] = expf(x[t] * scale);
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) part[threadIdx.x * kPer + t] = x[t];
  __syncthreads();
  if (threadIdx.x % kSplit == 0) {
    // the element's threads are adjacent: its 64 chains lie in order
    const float* p = part + threadIdx.x * kPer;
    float acc = p[0];
    for (int t = 1; t < kChains; ++t) acc = acc + p[t];
    out[(blockIdx.x * kThreads + threadIdx.x) / kSplit] = acc;
  }
}

}  // namespace

// out: (256, 128) f32 on the device.
extern "C" int basicrta_transcendental_ceiling(float* out, int iters,
                                               float scale, void* stream) {
  ceiling_kernel<<<kRows * kCols * kSplit / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(out, iters, scale);
  return static_cast<int>(cudaGetLastError());
}
