// K5: exclusive prefix sum of an int32 vector, and its total.
//
// Replaces the Pallas kernel gpuradixsort_tpu/kernels/scan.py::_scan_kernel
// (called by _exclusive_scan_2d and exclusive_scan).  out[i] = x[0] + ... +
// x[i - 1] and total = x[0] + ... + x[n - 1], both modulo 2^32 as int32 sums
// wrap in jnp.cumsum.  The kernels add in uint32_t, where wrapping is
// defined.
//
// Bound on the H100: HBM bytes.  x is read twice (the second read mostly
// from L2 at the sizes this engine scans) and out written once.
//
// Design: reduce, then scan, in three launches.  The TPU kernel walks the
// tiles in grid order and carries the running sum in SMEM; Hopper blocks run
// in no order, so nothing can carry between them:
//   1. scan_reduce: each block sums its chunk of kChunk elements;
//   2. scan_block_sums: one block scans the per-block sums in place (walking
//      them blockDim at a time with a carry) and writes the total after them;
//   3. scan_chunks: each block scans its chunk again, from its block's
//      exclusive offset.  The chunk is loaded into shared memory with
//      coalesced loads, each thread scans kItems consecutive elements, the
//      thread sums are scanned over the block, and the chunk leaves with
//      coalesced stores.
// The ragged edge (n not a multiple of kChunk) reads as zeros and is not
// stored.  A single pass with decoupled look-back is the faster design.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;
constexpr int kChunkPadded = kChunk + kChunk / 32;

// Shared index of chunk element i, padded by one word per 32 so that the
// per-thread runs of kItems words fall on distinct banks.
__device__ inline int padded(int i) { return i + (i >> 5); }

// Exclusive scan of x over the block (kThreads threads); total gets the
// block's sum.  All threads must call it.  sums holds 33 words.
__device__ inline uint32_t block_exclusive_scan(uint32_t x, uint32_t* sums,
                                                uint32_t& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  uint32_t warp_total;
  const uint32_t excl = grs::warp_exclusive_scan(x, lane, warp_total);
  if (lane == 0) sums[warp] = warp_total;
  __syncthreads();
  if (warp == 0) {
    uint32_t all;
    const uint32_t s = lane < kWarps ? sums[lane] : 0u;
    const uint32_t e = grs::warp_exclusive_scan(s, lane, all);
    if (lane < kWarps) sums[lane] = e;
    if (lane == 0) sums[32] = all;
  }
  __syncthreads();
  total = sums[32];
  const uint32_t out = sums[warp] + excl;
  __syncthreads();  // sums is rewritten by the next call
  return out;
}

__global__ void scan_reduce_kernel(const uint32_t* __restrict__ x, int64_t n,
                                   uint32_t* __restrict__ block_sums) {
  __shared__ uint32_t sums[33];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk;
  uint32_t local = 0;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + k * kThreads + threadIdx.x;
    if (i < n) local += x[i];
  }
  uint32_t total;
  block_exclusive_scan(local, sums, total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

// One block: block_sums[0..num_blocks) becomes its exclusive scan and
// block_sums[num_blocks] the total.
__global__ void scan_block_sums_kernel(uint32_t* __restrict__ block_sums,
                                       int64_t num_blocks) {
  __shared__ uint32_t sums[33];
  uint32_t carry = 0;
  for (int64_t c0 = 0; c0 < num_blocks; c0 += kThreads) {
    const int64_t i = c0 + threadIdx.x;
    const uint32_t v = i < num_blocks ? block_sums[i] : 0u;
    uint32_t total;
    const uint32_t excl = block_exclusive_scan(v, sums, total);
    if (i < num_blocks) block_sums[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) block_sums[num_blocks] = carry;
}

__global__ void scan_chunks_kernel(const uint32_t* __restrict__ x, int64_t n,
                                   const uint32_t* __restrict__ block_sums,
                                   uint32_t* __restrict__ out) {
  __shared__ uint32_t chunk[kChunkPadded];
  __shared__ uint32_t sums[33];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk;
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    chunk[padded(j)] = start + j < n ? x[start + j] : 0u;
  }
  __syncthreads();
  const int first = threadIdx.x * kItems;
  uint32_t local = 0;
  for (int k = 0; k < kItems; ++k) local += chunk[padded(first + k)];
  uint32_t total;
  uint32_t run = block_sums[blockIdx.x] + block_exclusive_scan(local, sums, total);
  for (int k = 0; k < kItems; ++k) {
    const uint32_t v = chunk[padded(first + k)];
    chunk[padded(first + k)] = run;
    run += v;
  }
  __syncthreads();
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (start + j < n) out[start + j] = chunk[padded(j)];
  }
}

}  // namespace

// x: n int32 (n >= 1).  out: n + num_blocks + 1 int32, num_blocks =
// ceil(n / 4096): the scan in its first n words, the per-block sums after
// them as scratch, and the total in its last word.  The caller sizes out,
// so num_blocks is passed and checked against this file's chunk.
// Returns cudaGetLastError() after the launches.
extern "C" int grs_exclusive_scan(const void* x, void* out, int64_t n,
                                  int64_t num_blocks, void* stream) {
  if (n < 1 || num_blocks != (n + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(x);
  uint32_t* sums = static_cast<uint32_t*>(out) + n;
  scan_reduce_kernel<<<static_cast<unsigned>(num_blocks), kThreads, 0, s>>>(
      in, n, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_block_sums_kernel<<<1, kThreads, 0, s>>>(sums, num_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_chunks_kernel<<<static_cast<unsigned>(num_blocks), kThreads, 0, s>>>(
      in, n, sums, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
