// K4: stable global destination of every key for one radix pass.
//
// Replaces the Pallas kernel gpuradixsort_tpu/kernels/radix.py::_dest_kernel
// (called by tile_destinations).  dest[i] = offsets[t, d_i] + the number of
// earlier keys of tile t (a contiguous stretch of `tile` keys) whose digit
// (key >> shift) & (radix - 1) equals d_i.  With the offsets of
// global_offsets, dest is a permutation of 0..N-1.
//
// Bound on the H100: HBM bytes.  Each key is read once and each destination
// written once (8 bytes a key), and each tile reads its row of the offsets
// table.
//
// Design: one warp per tile, up to eight tiles a block, and no block barrier,
// as K1 and K2 (radix_hist.cu, bucketize.cu).  The TPU kernel one-hot expands
// the digits and takes a prefix sum per bucket, because Mosaic has no
// per-element scatter.  Here the offsets already hold each digit's first
// destination in the tile, so no histogram and no scan are needed.  A warp:
//   1. reads its tile warp-striped, lane l's item j being element 32 j + l,
//      so that each warp load is 128 contiguous bytes and flat order (item,
//      lane) is element order, which keeps the pass stable.  A lane issues
//      the loads of a batch of up to 32 items (the whole default tile) before
//      it ranks any;
//   2. radix <= 32: lane r keeps the running destination of digit r in a
//      register, read once from the offsets row.  An item's destination is
//      that of its digit, read by one shuffle, plus its peers in lower lanes
//      (one ballot per digit bit, grs::DigitBallots); lane r then adds the
//      item's count of digit r;
//   3. radix 64-256: the running destinations live in a warp-private shared
//      table of `radix` words.  After every lane has read its slot, the
//      lowest lane of each peer group adds the group's size;
//   4. stores each destination where its key was, one coalesced 128-byte warp
//      store an item.
// Keys need only 4-byte alignment.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kMaxRadix = 256;
constexpr int kRegisterRadix = 32;  // radixes whose destinations fit a warp's lanes
constexpr int kBatch = 32;          // items a lane loads before it ranks them
constexpr int kMaxWarps = 8;        // tiles a block

template <int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    radix_dest_kernel(const uint32_t* __restrict__ keys,
                      const int32_t* __restrict__ offsets,
                      int32_t* __restrict__ dest, int64_t num_tiles, int tile,
                      int shift) {
  constexpr int kRadix = 1 << kBits;
  constexpr uint32_t kMask = kRadix - 1;
  extern __shared__ int tables[];  // radix > 32: [warps][radix]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;  // no block barrier follows

  const uint32_t* src = keys + t * tile + lane;
  int32_t* dst = dest + t * tile + lane;
  const int32_t* row = offsets + t * kRadix;
  const unsigned below = (1u << lane) - 1u;
  const int items = tile >> 5;

  int running = 0;  // radix <= 32: lane r, the next destination of digit r
  int* table = tables + warp * kRadix;
  if constexpr (kRadix <= kRegisterRadix) {
    if (lane < kRadix) running = row[lane];
  } else {
    for (int r = lane; r < kRadix; r += 32) table[r] = row[r];
    __syncwarp();
  }

  for (int j0 = 0; j0 < items; j0 += kBatch) {
    uint32_t k[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j0 + j < items) k[j] = __ldg(src + 32 * (j0 + j));
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j0 + j < items) {  // alike in every lane
        const uint32_t d = (k[j] >> shift) & kMask;
        const grs::DigitBallots<kBits> ballots(d, kBits);
        const unsigned peers = ballots.lanes_with(d, kBits);
        const int rank = __popc(peers & below);
        int out;
        if constexpr (kRadix <= kRegisterRadix) {
          out = __shfl_sync(grs::kFullWarp, running, d) + rank;
          running += __popc(ballots.lanes_with(lane, kBits));
        } else {
          out = table[d] + rank;
          __syncwarp();
          if (rank == 0) table[d] += __popc(peers);
          __syncwarp();
        }
        dst[32 * (j0 + j)] = out;
      }
    }
  }
}

}  // namespace

// keys: num_tiles * tile uint32 (4-byte aligned); offsets: (num_tiles, radix)
// int32; dest: num_tiles * tile int32.  One warp per tile: threads is 32 x
// the tiles of a block, at most 32 x 8.  tile is a multiple of 128; radix a
// power of two from 2 to 256; above 32 the block keeps threads / 32 x radix
// x 4 bytes in shared memory (8 KB at most).  Returns cudaGetLastError()
// after the launch.
extern "C" int grs_radix_dest(const void* keys, const void* offsets, void* dest,
                              int64_t num_tiles, int tile, int threads,
                              int shift, int radix, void* stream) {
  if (radix < 2 || radix > kMaxRadix || (radix & (radix - 1)) != 0 ||
      threads < 32 || threads % 32 != 0 || threads > 32 * kMaxWarps ||
      tile <= 0 || tile % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles > 0) {
    const size_t smem = radix > kRegisterRadix
                            ? static_cast<size_t>(threads / 32) * radix * sizeof(int)
                            : 0;
    const int64_t per_block = threads / 32;
    const dim3 grid(static_cast<unsigned>((num_tiles + per_block - 1) / per_block));
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* k = static_cast<const uint32_t*>(keys);
    const auto* o = static_cast<const int32_t*>(offsets);
    auto* d = static_cast<int32_t*>(dest);
    switch (__builtin_ctz(static_cast<unsigned>(radix))) {
      case 1: radix_dest_kernel<1><<<grid, threads, smem, s>>>(k, o, d, num_tiles, tile, shift); break;
      case 2: radix_dest_kernel<2><<<grid, threads, smem, s>>>(k, o, d, num_tiles, tile, shift); break;
      case 3: radix_dest_kernel<3><<<grid, threads, smem, s>>>(k, o, d, num_tiles, tile, shift); break;
      case 4: radix_dest_kernel<4><<<grid, threads, smem, s>>>(k, o, d, num_tiles, tile, shift); break;
      case 5: radix_dest_kernel<5><<<grid, threads, smem, s>>>(k, o, d, num_tiles, tile, shift); break;
      case 6: radix_dest_kernel<6><<<grid, threads, smem, s>>>(k, o, d, num_tiles, tile, shift); break;
      case 7: radix_dest_kernel<7><<<grid, threads, smem, s>>>(k, o, d, num_tiles, tile, shift); break;
      default: radix_dest_kernel<8><<<grid, threads, smem, s>>>(k, o, d, num_tiles, tile, shift); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
