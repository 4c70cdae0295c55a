// K4: stable global destination of every key for one radix pass.
//
// Replaces the Pallas kernel gpuradixsort_tpu/kernels/radix.py::_dest_kernel
// (called by tile_destinations).  dest[i] = offsets[t, d_i] + the number of
// earlier keys of tile t (a contiguous stretch of `tile` keys) whose digit
// (key >> shift) & (radix - 1) equals d_i.  With the offsets of
// global_offsets, dest is a permutation of 0..N-1.
//
// Bound on the H100: HBM bytes at radix 2 to 16.  Each key is read once and
// each destination written once (8 bytes per key), and each tile reads its
// row of the offsets table.  At radix 256 the per-chunk scans over digits
// cost more than the bytes.
//
// Design: K2 (bucketize.cu) without the staging.  The TPU kernel one-hot
// expands the digits and takes a prefix sum per bucket, because Mosaic has no
// per-element scatter; here one block walks its tile in chunks of blockDim
// keys, thread i owning key c0 + i:
//   1. a warp ranks its lanes within a digit with one ballot per digit bit
//      and popc(peers & lanes below);
//   2. the per-(digit, warp) counts are scanned over warps, one warp per
//      digit (r = warp; r < radix; r += nwarps), on top of the digit's
//      running destination, which starts at offsets[t, r] and carries
//      across chunks;
//   3. every thread stores its own int32 destination, so the stores of a
//      warp are coalesced.
// The table is digit-major ([radix][nwarps]) so that the scan over warps
// reads consecutive words.  Flat order is (chunk, warp, lane), so equal
// digits keep their order.  Shared memory is sized by the radix.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kMaxRadix = 256;
constexpr int kMaxWarps = 32;

__global__ void radix_dest_kernel(const uint32_t* __restrict__ keys,
                                  const int32_t* __restrict__ offsets,
                                  int32_t* __restrict__ dest, int tile,
                                  int shift, int radix, int bits) {
  extern __shared__ int smem[];
  const int nwarps = blockDim.x >> 5;
  int* running = smem;                  // [radix]: next destination of digit r
  int* warp_base = smem + radix;        // [radix][nwarps]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t t = blockIdx.x;
  const int64_t base = t * tile;
  const uint32_t mask = static_cast<uint32_t>(radix - 1);
  const unsigned lanes_below = (1u << lane) - 1u;
  const int table = radix * nwarps;

  for (int r = tid; r < radix; r += blockDim.x) running[r] = offsets[t * radix + r];

  for (int c0 = 0; c0 < tile; c0 += blockDim.x) {
    const uint32_t d = (keys[base + c0 + tid] >> shift) & mask;
    const unsigned peers = grs::lanes_with_digit(d, bits);
    const int rank = __popc(peers & lanes_below);

    for (int i = tid; i < table; i += blockDim.x) warp_base[i] = 0;
    __syncthreads();
    if (rank == 0) warp_base[d * nwarps + warp] = __popc(peers);
    __syncthreads();
    for (int r = warp; r < radix; r += nwarps) {
      const int before = running[r];
      int total;
      const int count = lane < nwarps ? warp_base[r * nwarps + lane] : 0;
      const int excl = grs::warp_exclusive_scan(count, lane, total);
      if (lane < nwarps) warp_base[r * nwarps + lane] = before + excl;
      __syncwarp();
      if (lane == 0) running[r] = before + total;
    }
    __syncthreads();
    dest[base + c0 + tid] = warp_base[d * nwarps + warp] + rank;
    __syncthreads();  // warp_base is cleared by the next chunk
  }
}

}  // namespace

// keys: num_tiles * tile uint32; offsets: (num_tiles, radix) int32;
// dest: num_tiles * tile int32.  threads must be a multiple of 32, at most
// 1024, and divide tile; radix is a power of two <= 256.
// Returns cudaGetLastError() after the launch.
extern "C" int grs_radix_dest(const void* keys, const void* offsets, void* dest,
                              int64_t num_tiles, int tile, int threads,
                              int shift, int radix, void* stream) {
  if (radix < 2 || radix > kMaxRadix || (radix & (radix - 1)) != 0 ||
      threads % 32 != 0 || threads > 32 * kMaxWarps || tile % threads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(radix) * (1 + threads / 32) * sizeof(int);
  if (num_tiles > 0) {
    radix_dest_kernel<<<static_cast<unsigned>(num_tiles), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys),
        static_cast<const int32_t*>(offsets), static_cast<int32_t*>(dest), tile,
        shift, radix, __builtin_ctz(static_cast<unsigned>(radix)));
  }
  return static_cast<int>(cudaGetLastError());
}
