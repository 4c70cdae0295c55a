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

// ---------------------------------------------------------------------------
// dest_scatter: K4's destinations and the indexed stores after them, as one
// kernel.
//
// Replaces the Pallas kernel _dest_kernel together with the scatter the JAX
// package runs after it (gpuradixsort_tpu/ops/permute.py::
// scatter_by_destination, a plain XLA scatter): for every moved column c,
// out_c[dest[i]] = col_c[i], with dest[i] as K4 computes it above.  No
// destination buffer is written or read.
//
// Bound on the H100: HBM bytes.  The rank keys are read once (4 bytes a
// key), each moved column is read once and written once, and each tile reads
// its rows of K1's table and of the offsets table.
//
// Design: K4's geometry and rank step (one warp a tile, warp-striped loads,
// ballot ranks; running slots in lane registers up to radix 32, in a
// warp-private shared table above).  The warp ranks its whole tile first
// and stages the tile's permutation, not its values, in shared memory: for
// each local position p in digit order (its digit's start in the tile, the
// exclusive sum of K1's row, plus the key's rank), the tile row it takes (16
// bits) and its destination.  Then, for each column, lane p moves row src[p]
// to dst[p]: consecutive lanes write consecutive rows of one digit's run,
// and the rows read lie in the tile's stretch of the column, served from L1
// and L2.  The ranking is done once for every column of the launch.  On the
// H100 this beat storing each row at its destination from the lane that
// read it (coalesced loads, stores spread over the tile's runs) at every
// radix and size measured (PERF.md, Findings).  A row moves as units of 16,
// 8, 4, 2 or 1 bytes, the widest that divides the row and both of its
// column's addresses.  A column's loads and stores go through plain
// pointers, which may alias, so the compiler keeps a lane's batch of loads
// ahead of its stores.

namespace {

constexpr int kMaxColumns = 8;              // moved columns a launch
// Keys a lane loads before it ranks them: 16, not K4's 32, keeps the kernel
// free of spills (about 128 registers); on the H100 it was 26% faster at
// radix 2 and 2% slower at radix 16 than 32 (PERF.md, Findings).
constexpr int kRankBatch = 16;
constexpr int kMoveBatch = 8;               // rows a lane loads before it stores them
constexpr size_t kSharedLimit = 48 * 1024;  // a block's shared memory without opt-in
constexpr size_t kMaxShared = 232448;       // a block's shared memory with opt-in (H100)

struct MovedColumn {
  const void* src;
  void* dst;
  int64_t units;  // units a row
  int64_t unit;   // bytes a unit: 1, 2, 4, 8 or 16
};

// Passed by value as a launch parameter, so a captured graph holds its own copy.
struct MovedColumns {
  MovedColumn col[kMaxColumns];
  int count;
};

// Shared bytes of one warp: radix > 32, the running slots and deltas
// (2 x radix int32); then the tile's destinations (int32) and rows (16 bits)
// by position.  Rounded up to 16 bytes.
__host__ __device__ inline size_t dest_scatter_warp_bytes(int radix, int tile) {
  const size_t bytes = (radix > kRegisterRadix ? 8 * static_cast<size_t>(radix) : 0) +
                       6 * static_cast<size_t>(tile);
  return (bytes + 15) / 16 * 16;
}

// Every row of the tile whose first row is `first` to its staged
// destination, lane p taking positions p, p + 32, ...
template <typename T>
__device__ __forceinline__ void move_rows(const MovedColumn& c, int64_t first,
                                          const int* dst_of, const uint16_t* src_of, int tile,
                                          int lane) {
  const T* in = static_cast<const T*>(c.src);
  T* out = static_cast<T*>(c.dst);
  if (c.units == 1) {
    for (int p0 = lane; p0 < tile; p0 += 32 * kMoveBatch) {
      T v[kMoveBatch];
      int o[kMoveBatch];
#pragma unroll
      for (int j = 0; j < kMoveBatch; ++j) {
        if (p0 + 32 * j < tile) {
          o[j] = dst_of[p0 + 32 * j];
          v[j] = in[first + src_of[p0 + 32 * j]];
        }
      }
#pragma unroll
      for (int j = 0; j < kMoveBatch; ++j)
        if (p0 + 32 * j < tile) out[o[j]] = v[j];
    }
  } else {  // consecutive lanes take consecutive units of the staged rows
    const int64_t w = c.units;
    for (int64_t q = lane; q < tile * w; q += 32) {
      const int p = static_cast<int>(q / w);
      const int64_t k = q - p * w;
      out[dst_of[p] * w + k] = in[(first + src_of[p]) * w + k];
    }
  }
}

template <int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    dest_scatter_kernel(const uint32_t* __restrict__ keys, const int32_t* __restrict__ hist,
                        const int32_t* __restrict__ offsets, const MovedColumns cols,
                        int64_t num_tiles, int tile, int shift) {
  constexpr int kRadix = 1 << kBits;
  constexpr uint32_t kMask = kRadix - 1;
  extern __shared__ __align__(16) unsigned char staging[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;  // no block barrier follows

  const int64_t base = t * tile;
  const uint32_t* src = keys + base + lane;
  const int32_t* row = offsets + t * kRadix;
  const unsigned below = (1u << lane) - 1u;
  const int items = tile >> 5;

  // The warp's shared memory: radix > 32, its tables of running slots and
  // deltas; then the tile's destinations and rows by position.
  unsigned char* mine = staging + warp * dest_scatter_warp_bytes(kRadix, tile);
  int* run_table = reinterpret_cast<int*>(mine);
  int* delta_table = run_table + kRadix;
  int* dst_of = reinterpret_cast<int*>(mine + (kRadix > kRegisterRadix ? 8 * kRadix : 0));
  uint16_t* src_of = reinterpret_cast<uint16_t*>(dst_of + tile);

  // Digit r's next local position, starting at the exclusive sum of K1's
  // row, and the delta from a position to its destination, offsets - start.
  int run = 0, delta = 0;  // radix <= 32: lane r's, digit r's
  if constexpr (kRadix <= kRegisterRadix) {
    int total;
    run = grs::warp_exclusive_scan(lane < kRadix ? hist[t * kRadix + lane] : 0, lane, total);
    delta = (lane < kRadix ? row[lane] : 0) - run;
  } else {
    constexpr int kPer = kRadix / 32;  // digits a lane, consecutive
    int h[kPer], sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      h[i] = hist[t * kRadix + lane * kPer + i];
      sum += h[i];
    }
    int total;
    int start = grs::warp_exclusive_scan(sum, lane, total);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane * kPer + i;
      run_table[d] = start;
      delta_table[d] = row[d] - start;
      start += h[i];
    }
    __syncwarp();
  }

  // Rank step: K4's, with each key's position and destination staged.
  for (int j0 = 0; j0 < items; j0 += kRankBatch) {
    uint32_t k[kRankBatch];
#pragma unroll
    for (int j = 0; j < kRankBatch; ++j)
      if (j0 + j < items) k[j] = __ldg(src + 32 * (j0 + j));
#pragma unroll
    for (int j = 0; j < kRankBatch; ++j) {
      if (j0 + j < items) {  // alike in every lane
        const uint32_t d = (k[j] >> shift) & kMask;
        const grs::DigitBallots<kBits> ballots(d, kBits);
        const unsigned peers = ballots.lanes_with(d, kBits);
        const int rank = __popc(peers & below);
        int pos, dl;
        if constexpr (kRadix <= kRegisterRadix) {
          pos = __shfl_sync(grs::kFullWarp, run, d) + rank;
          dl = __shfl_sync(grs::kFullWarp, delta, d);
          run += __popc(ballots.lanes_with(lane, kBits));
        } else {
          pos = run_table[d] + rank;
          dl = delta_table[d];
          __syncwarp();
          if (rank == 0) run_table[d] += __popc(peers);
          __syncwarp();
        }
        dst_of[pos] = pos + dl;
        src_of[pos] = static_cast<uint16_t>(32 * (j0 + j) + lane);
      }
    }
  }
  __syncwarp();

  // Move step: every column, by the width of its unit.
  for (int c = 0; c < cols.count; ++c) {
    switch (cols.col[c].unit) {
      case 16: move_rows<uint4>(cols.col[c], base, dst_of, src_of, tile, lane); break;
      case 8: move_rows<uint2>(cols.col[c], base, dst_of, src_of, tile, lane); break;
      case 4: move_rows<uint32_t>(cols.col[c], base, dst_of, src_of, tile, lane); break;
      case 2: move_rows<uint16_t>(cols.col[c], base, dst_of, src_of, tile, lane); break;
      default: move_rows<uint8_t>(cols.col[c], base, dst_of, src_of, tile, lane); break;
    }
  }
}

// Launches the instance of `radix` (a power of two, 2 to 256); above 48 KB of
// shared memory, after opting in to it.
template <int kBits>
cudaError_t launch_dest_scatter(int radix, dim3 grid, int threads, size_t smem,
                                cudaStream_t s, const uint32_t* keys, const int32_t* hist,
                                const int32_t* offsets, const MovedColumns& cols,
                                int64_t num_tiles, int tile, int shift) {
  if (radix != 1 << kBits) {
    if constexpr (kBits > 1) {
      return launch_dest_scatter<kBits - 1>(radix, grid, threads, smem, s, keys, hist,
                                            offsets, cols, num_tiles, tile, shift);
    }
    return cudaErrorInvalidValue;
  }
  if (smem > kSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        dest_scatter_kernel<kBits>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dest_scatter_kernel<kBits><<<grid, threads, smem, s>>>(keys, hist, offsets, cols, num_tiles,
                                                         tile, shift);
  return cudaGetLastError();
}

}  // namespace

// keys: num_tiles * tile uint32, the rank source (4-byte aligned); hist and
// offsets: (num_tiles, radix) int32, K1's table and global_offsets of it.
// columns: num_columns (1 to 8) descriptors of four int64 words each, read
// here before the launch: the source's and the destination's address, the
// units a row and the bytes a unit (1, 2, 4, 8 or 16; both addresses aligned
// to it); every column has num_tiles * tile rows, and no destination
// overlaps a source or another destination.  One warp per tile: threads is
// 32 x the tiles of a block, at most 32 x 8; tile is a multiple of 128; radix
// a power of two from 2 to 256.  A block keeps threads / 32 x
// dest_scatter_warp_bytes in shared memory, at most 232,448 bytes.  Returns
// the launch's error, or cudaGetLastError() after it.
extern "C" int grs_radix_dest_scatter(const void* keys, const void* hist, const void* offsets,
                                      const int64_t* columns, int num_columns,
                                      int64_t num_tiles, int tile, int threads, int shift,
                                      int radix, void* stream) {
  if (radix < 2 || radix > kMaxRadix || (radix & (radix - 1)) != 0 ||
      threads < 32 || threads % 32 != 0 || threads > 32 * kMaxWarps ||
      tile <= 0 || tile % 128 != 0 || num_columns < 1 || num_columns > kMaxColumns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MovedColumns cols{};
  cols.count = num_columns;
  for (int c = 0; c < num_columns; ++c) {
    const int64_t* w = columns + 4 * c;
    const int64_t unit = w[3];
    if ((unit != 1 && unit != 2 && unit != 4 && unit != 8 && unit != 16) || w[2] < 1 ||
        w[0] % unit != 0 || w[1] % unit != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cols.col[c] = {reinterpret_cast<const void*>(w[0]), reinterpret_cast<void*>(w[1]), w[2],
                   unit};
  }
  const size_t smem = static_cast<size_t>(threads / 32) * dest_scatter_warp_bytes(radix, tile);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const int64_t per_block = threads / 32;
  const dim3 grid(static_cast<unsigned>((num_tiles + per_block - 1) / per_block));
  return static_cast<int>(launch_dest_scatter<8>(
      radix, grid, threads, smem, static_cast<cudaStream_t>(stream),
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(hist),
      static_cast<const int32_t*>(offsets), cols, num_tiles, tile, shift));
}
