// A trial route for K5 (csrc/scan.cu) on inputs of a few chunks, built only
// by kernel_ab.py --sweep and used by no module of the port.
//
// One block of 1,024 threads scans the whole input, 8,192 elements a step
// (8 consecutive elements a thread), and carries the running sum from step
// to step: no scratch, no memset, no counter and no look-back.  Each thread
// issues the next step's loads before it scans the current step.  Sums wrap
// modulo 2^32 in uint32_t, as in csrc/scan.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "../gpuradixsort_tpu_torch/csrc/warp.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int64_t kStep = int64_t{kThreads} * kItems;

// Elements g .. g + kItems - 1 (zeros past n), by two 16-byte loads where
// they are whole and x is 16-byte aligned.
__device__ __forceinline__ void load_items(const uint32_t* __restrict__ x, int64_t n, int64_t g,
                                           bool vec, uint32_t (&v)[kItems]) {
  if (vec && g + kItems <= n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + g));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(x + g + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = g + i < n ? __ldg(x + g + i) : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
    one_block_scan(const uint32_t* __restrict__ x, int64_t n, uint32_t* __restrict__ out,
                   bool vec) {
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t carry = 0;
  uint32_t v[kItems], next[kItems];
  load_items(x, n, int64_t{kItems} * threadIdx.x, vec, next);
  for (int64_t base = 0; base < n; base += kStep) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = next[i];
    const int64_t g = base + int64_t{kItems} * threadIdx.x;
    if (base + kStep < n) load_items(x, n, g + kStep, vec, next);
    uint32_t local = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) local += v[i];
    uint32_t warp_total;
    const uint32_t excl = grs::warp_exclusive_scan(local, lane, warp_total);
    if (lane == 0) warp_sums[warp] = warp_total;
    __syncthreads();
    uint32_t step_total;
    const uint32_t below = grs::warp_exclusive_scan(warp_sums[lane], lane, step_total);
    __syncthreads();  // every warp has read warp_sums before the next step writes it
    uint32_t r[kItems];
    uint32_t run = carry + __shfl_sync(grs::kFullWarp, below, warp) + excl;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      r[i] = run;
      run += v[i];
    }
    if (g + kItems <= n) {
      *reinterpret_cast<uint4*>(out + g) = make_uint4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<uint4*>(out + g + 4) = make_uint4(r[4], r[5], r[6], r[7]);
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        if (g + i < n) out[g + i] = r[i];
    }
    carry += step_total;
  }
  if (threadIdx.x == 0) out[n] = carry;
}

}  // namespace

// x: n int32 (n >= 1).  out: n + 1 int32, 16-byte aligned: the scan, then
// the total.  Returns cudaGetLastError() after the launch.
extern "C" int grs_exclusive_scan_one_block(const void* x, void* out, int64_t n, void* stream) {
  if (n < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  one_block_scan<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, static_cast<uint32_t*>(out),
      reinterpret_cast<uintptr_t>(x) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}
