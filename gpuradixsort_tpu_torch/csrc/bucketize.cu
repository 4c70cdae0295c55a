// K2: stable sort of every tile's (key, index) pairs by the current digit.
//
// Replaces the Pallas kernel
// gpuradixsort_tpu/kernels/bucketize.py::_bucketize_kernel (with
// _bucketize_tile and _row_bitonic_sortkeys; called by bucketize_tiles).
// The output equals a per-tile argsort(digit, stable) applied to key and
// index.
//
// Bound on the H100: HBM bytes.  Each key is read twice (once for the tile
// histogram, once to place it; the second read mostly hits L1/L2) and each
// index once, and key and index are each written once.
//
// Design: one block per tile, a stable counting split in shared memory.  The
// TPU kernel runs a 28-stage bitonic network per row and a gather loop per
// source row because the TPU has no per-element gather or scatter; here every
// element goes straight to its slot:
//   1. the tile histogram, with warp-aggregated shared atomics, and its
//      exclusive scan over digits (digit_start), by one warp's shuffles;
//   2. the tile is walked in chunks of blockDim elements, thread i owning
//      element c0 + i.  A warp ranks its lanes within a digit with one
//      ballot per digit bit and popc(peers & lanes below); per-warp counts
//      are scanned over (chunk, warp) into warp_base, one warp per digit,
//      lane w holding warp w's count;
//   3. dst = digit_start[d] + warp_base[warp][d] + lane rank, staged in
//      shared memory, so the tile leaves with coalesced stores.
// Flat order is (chunk, warp, lane), so equal digits keep their order.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kMaxRadix = 16;
constexpr int kMaxWarps = 32;

__global__ void bucketize_kernel(const uint32_t* __restrict__ keys,
                                 const uint32_t* __restrict__ idx,
                                 uint32_t* __restrict__ out_keys,
                                 uint32_t* __restrict__ out_idx, int tile,
                                 int shift, int radix, int bits) {
  extern __shared__ uint32_t staged[];  // [0, tile) keys, [tile, 2 tile) idx
  __shared__ int digit_start[kMaxRadix];
  __shared__ int running[kMaxRadix];
  __shared__ int warp_base[kMaxWarps][kMaxRadix];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  const uint32_t mask = static_cast<uint32_t>(radix - 1);
  const unsigned lanes_below = (1u << lane) - 1u;

  if (tid < radix) {
    digit_start[tid] = 0;
    running[tid] = 0;
  }
  __syncthreads();

  // 1. Tile histogram, then its exclusive scan over digits.
  for (int i = tid; i < tile; i += blockDim.x) {
    const uint32_t d = (keys[base + i] >> shift) & mask;
    const unsigned peers = grs::lanes_with_digit(d, bits);
    if (lane == __ffs(peers) - 1) atomicAdd(&digit_start[d], __popc(peers));
  }
  __syncthreads();
  if (warp == 0) {
    int total;
    const int count = lane < radix ? digit_start[lane] : 0;
    const int excl = grs::warp_exclusive_scan(count, lane, total);
    if (lane < radix) digit_start[lane] = excl;
  }
  __syncthreads();

  // 2-3. Rank and place one chunk of blockDim elements at a time.
  for (int c0 = 0; c0 < tile; c0 += blockDim.x) {
    const uint32_t k = keys[base + c0 + tid];
    const uint32_t v = idx[base + c0 + tid];
    const uint32_t d = (k >> shift) & mask;
    const unsigned peers = grs::lanes_with_digit(d, bits);
    const int rank = __popc(peers & lanes_below);

    if (lane < radix) warp_base[warp][lane] = 0;
    __syncwarp();
    if (rank == 0) warp_base[warp][d] = __popc(peers);
    __syncthreads();
    for (int r = warp; r < radix; r += nwarps) {
      const int before = running[r];
      int total;
      const int count = lane < nwarps ? warp_base[lane][r] : 0;
      const int excl = grs::warp_exclusive_scan(count, lane, total);
      if (lane < nwarps) warp_base[lane][r] = before + excl;
      __syncwarp();
      if (lane == 0) running[r] = before + total;
    }
    __syncthreads();
    const int dst = digit_start[d] + warp_base[warp][d] + rank;
    staged[dst] = k;
    staged[tile + dst] = v;
    __syncthreads();  // warp_base is rewritten by the next chunk
  }

  for (int i = tid; i < tile; i += blockDim.x) {
    out_keys[base + i] = staged[i];
    out_idx[base + i] = staged[tile + i];
  }
}

}  // namespace

// keys, idx, out_keys, out_idx: num_tiles * tile uint32.  threads must be a
// multiple of 32, at most 1024, and divide tile; radix <= 16.
// Returns cudaGetLastError() after the launch.
extern "C" int grs_bucketize(const void* keys, const void* idx, void* out_keys,
                             void* out_idx, int64_t num_tiles, int tile,
                             int threads, int shift, int radix, void* stream) {
  if (radix > kMaxRadix || threads % 32 != 0 || threads > 32 * kMaxWarps ||
      tile % threads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(tile) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucketize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_tiles > 0) {
    bucketize_kernel<<<static_cast<unsigned>(num_tiles), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(idx),
        static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(out_idx),
        tile, shift, radix, __builtin_ctz(static_cast<unsigned>(radix)));
  }
  return static_cast<int>(cudaGetLastError());
}
