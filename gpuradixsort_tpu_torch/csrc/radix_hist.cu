// K1: per-tile digit histograms.
//
// Replaces the Pallas kernel gpuradixsort_tpu/kernels/radix.py::_hist_kernel
// (called by tile_histograms).  hist[t, r] = number of keys in tile t (a
// contiguous stretch of `tile` keys) with (key >> shift) & (radix - 1) == r.
//
// Bound on the H100: HBM bytes.  Each key is read once (4 bytes) and each
// tile writes radix int32 counts; the arithmetic is a shift, a mask and one
// counter update per key.
//
// Design: one warp per tile, up to eight tiles a block, and no block barrier,
// so that many loads are in flight and no two warps share a counter.  The TPU
// kernel one-hot expands the digits and reduces them with a selector matmul
// because Mosaic has no scatter.  A warp:
//   1. issues all of a lane's loads before it counts: 16-byte loads, eight a
//      lane for the default 1,024-key tile (a histogram ignores order, so
//      each lane takes four consecutive keys per load);
//   2. radix <= 16: each lane counts its keys in registers, sixteen 8-bit
//      fields in four words (at most 32 keys a lane per batch, so no field
//      overflows), and the warp sums the fields with __reduce_add_sync, two
//      16-bit fields a word: no shared memory, no atomics, no counter that
//      two lanes update.  Tiles of more than 32 keys a lane repeat this per
//      batch of 32;
//   3. radix 32 to 256: 8-bit fields again, in a warp-private shared table
//      with one column per lane (row d / 4, byte d % 4).  A lane adds only to
//      its own column, whose bank is its lane number, so the adds need no
//      ballot, never conflict and cost the same on skewed keys; at the end
//      (or every 224 keys a lane) each lane sums and clears whole rows.
// Integer counts make the result deterministic.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kMaxRadix = 256;
constexpr int kPackedRadix = 16;   // radixes counted in registers
constexpr int kBatch = 8;          // 16-byte loads a lane holds: 32 keys
constexpr int kMaxWarps = 8;       // tiles a block

__device__ __forceinline__ uint4 load_quad(const uint32_t* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// One more key of digit d (< 16): its 8-bit field is byte d % 4 of c[d / 4].
__device__ __forceinline__ void count_in_fields(uint32_t (&c)[4], uint32_t d) {
  const uint32_t one = 1u << ((d & 3u) << 3);
  const uint32_t word = d >> 2;
#pragma unroll
  for (int w = 0; w < 4; ++w) c[w] += word == static_cast<uint32_t>(w) ? one : 0u;
}

// One more key of digit d in the lane's column of a warp's table.  No other
// lane writes the word; the atomic only spares a load-add-store chain.
__device__ __forceinline__ void count_in_column(uint32_t* table, uint32_t d, int lane) {
  atomicAdd(&table[32 * (d >> 2) + lane], 1u << ((d & 3u) << 3));
}

// Adds rows lane and lane + 32 of the table into total (digits 4 row + b) and
// clears them.  Lane l reads column (i + l) % 32 at step i: one bank a lane.
__device__ __forceinline__ void drain_columns(uint32_t* table, int rows, int lane,
                                              uint32_t (&total)[2][4]) {
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = lane + 32 * h;
    if (row < rows) {
      uint32_t even = 0, odd = 0;  // bytes 0 and 2, 1 and 3: sums <= 32 x 255
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        uint32_t* word = table + 32 * row + ((i + lane) & 31);
        const uint32_t x = *word;
        *word = 0;
        even += x & 0x00ff00ffu;
        odd += (x >> 8) & 0x00ff00ffu;
      }
      total[h][0] += even & 0xffffu;
      total[h][1] += odd & 0xffffu;
      total[h][2] += even >> 16;
      total[h][3] += odd >> 16;
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    radix_hist_kernel(const uint32_t* __restrict__ keys, int32_t* __restrict__ hist,
                      int64_t num_tiles, int tile, int shift, int radix, bool vec) {
  extern __shared__ uint32_t tables[];  // radix > 16: [warps][radix / 4][32]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;  // no block barrier follows

  const uint32_t* src = keys + t * tile + 4 * lane;
  int32_t* out = hist + t * radix;
  const uint32_t mask = static_cast<uint32_t>(radix - 1);
  const int quads = tile >> 7;  // 16-byte loads a lane

  if (radix <= kPackedRadix) {
    uint32_t total[kPackedRadix] = {};  // the tile's counts, alike in every lane
    for (int q0 = 0; q0 < quads; q0 += kBatch) {
      uint4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (q0 + j < quads) x[j] = load_quad(src + 128 * (q0 + j), vec);
      uint32_t c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (q0 + j < quads) {
          count_in_fields(c, (x[j].x >> shift) & mask);
          count_in_fields(c, (x[j].y >> shift) & mask);
          count_in_fields(c, (x[j].z >> shift) & mask);
          count_in_fields(c, (x[j].w >> shift) & mask);
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (4 * w < radix) {
          // Fields 0 and 2, then 1 and 3, as 16-bit pairs: sums <= 32 x 32.
          const unsigned even = __reduce_add_sync(grs::kFullWarp, c[w] & 0x00ff00ffu);
          const unsigned odd = __reduce_add_sync(grs::kFullWarp, (c[w] >> 8) & 0x00ff00ffu);
          total[4 * w] += even & 0xffffu;
          total[4 * w + 1] += odd & 0xffffu;
          total[4 * w + 2] += even >> 16;
          total[4 * w + 3] += odd >> 16;
        }
      }
    }
    uint32_t mine = 0;
#pragma unroll
    for (int r = 0; r < kPackedRadix; ++r)
      if (lane == r) mine = total[r];
    if (lane < radix) out[lane] = static_cast<int32_t>(mine);
  } else {
    const int rows = radix >> 2;
    uint32_t* table = tables + static_cast<size_t>(warp) * rows * 32;
    for (int r = 0; r < rows; ++r) table[32 * r + lane] = 0;
    uint32_t total[2][4] = {};
    int held = 0;  // keys a lane has counted since the last drain
    for (int q0 = 0; q0 < quads; q0 += kBatch) {
      uint4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (q0 + j < quads) x[j] = load_quad(src + 128 * (q0 + j), vec);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (q0 + j < quads) {
          count_in_column(table, (x[j].x >> shift) & mask, lane);
          count_in_column(table, (x[j].y >> shift) & mask, lane);
          count_in_column(table, (x[j].z >> shift) & mask, lane);
          count_in_column(table, (x[j].w >> shift) & mask, lane);
        }
      }
      held += 4 * kBatch;
      if (held + 4 * kBatch > 255 || q0 + kBatch >= quads) {  // a field holds 255
        drain_columns(table, rows, lane, total);
        held = 0;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = lane + 32 * h;
      if (row < rows) {
#pragma unroll
        for (int b = 0; b < 4; ++b) out[4 * row + b] = static_cast<int32_t>(total[h][b]);
      }
    }
  }
}

}  // namespace

// keys: num_tiles * tile uint32; hist: (num_tiles, radix) int32.  One warp
// per tile: threads is 32 x the tiles of a block, at most 32 x 8.  tile is a
// multiple of 128; radix a power of two from 2 to 256; above 16 the block
// keeps threads / 32 x radix x 32 bytes in shared memory (64 KB at most).
// Returns cudaGetLastError() after the launch.
extern "C" int grs_radix_hist(const void* keys, void* hist, int64_t num_tiles,
                              int tile, int threads, int shift, int radix,
                              void* stream) {
  const auto aligned16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (radix < 2 || radix > kMaxRadix || (radix & (radix - 1)) != 0 ||
      threads < 32 || threads % 32 != 0 || threads > 32 * kMaxWarps ||
      tile <= 0 || tile % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = aligned16(keys);
  const size_t smem = radix > kPackedRadix
                          ? static_cast<size_t>(threads / 32) * radix * 32
                          : 0;
  if (num_tiles > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          radix_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t per_block = threads / 32;
    radix_hist_kernel<<<static_cast<unsigned>((num_tiles + per_block - 1) / per_block),
                        threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(hist), num_tiles, tile,
        shift, radix, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by any entry point of this library.
extern "C" const char* grs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
