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

#include "tile.cuh"
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
// key), each moved column is read once and written once, and each partition
// reads its tiles' rows of K1's table and its first tile's row of the
// offsets table.
//
// Design: a partition of `per_block` consecutive tiles (1, 2, 4 or 8), one
// warp a tile, is placed as a whole, so that each digit's rows leave it as
// one run of about per_block x tile / radix rows.  A tile's own runs are
// about tile / radix rows long: 4 at radix 256, a 16-byte piece of a 4-byte
// column, half a 32-byte sector.  The offsets are digit-major, then
// tile-major (global_offsets), so offsets[t + 1, d] = offsets[t, d] +
// hist[t, d]: digit d's rows of consecutive tiles are neighbours in the
// output, and the first tile's row of the offsets places the whole
// partition.  A block is one partition of several tiles, or several
// partitions of one tile each, which never wait for each other.
//   1. The partition reads K1's rows of its tiles into shared memory and
//      turns them into each digit's position base in each tile: the
//      partition's start of the digit (the exclusive sum over digits of its
//      counts in the partition), plus its count in the partition's earlier
//      tiles.  Positions are digit-major, then tile-major, then in tile
//      order, so the pass stays stable.  The destination of position p of
//      digit d is offsets[t0, d] + p - start[d]; that row is loaded at the
//      start, beside K1's.  A tile alone at radix <= 32 keeps its bases and
//      deltas in lane registers instead, from one warp scan, as K4 does:
//      nothing waits for shared memory before its rank.
//   2. Each warp ranks its tile as K4 does (warp-striped loads, ballot
//      ranks; running slots in lane registers up to radix 32, in the tile's
//      row of the shared bases above, read and advanced by each peer
//      group's lowest lane) and stages, for each position, the partition
//      row it takes (16 bits) and its destination (int32).  The values are
//      not staged.
//   3. After the partition's barrier, for each column, consecutive threads
//      take consecutive positions: a warp's stores cover one run of a
//      digit, and the rows read lie in the partition's stretch of the
//      column, served from L1 and L2.  The ranking is done once for every
//      column of the launch.
// On the H100 ballots beat __match_any_sync for the rank above radix 32
// (PERF.md, Findings).  A row moves as units of 16, 8, 4, 2 or 1 bytes, the
// widest that divides the row and both of its column's addresses.  A
// column's loads and stores go through plain pointers, which may alias, so
// the compiler keeps a thread's batch of loads ahead of its stores.

namespace {

constexpr int kMaxColumns = 8;              // moved columns a launch
// Keys a lane loads before it ranks them, the default tile whole: K4's 32.
// In this design it takes no spills (128 registers) and was up to 5% faster
// than 16 at radix 2 on the H100; in the earlier one-tile-a-warp design 16
// was faster (PERF.md, Findings).
constexpr int kRankBatch = 32;
constexpr int kMoveBatch = 8;               // rows a thread loads before it stores them
constexpr int kMaxPartition = 8;            // tiles a partition: one warp each
constexpr int kMaxPartitionRows = 1 << 16;  // a partition's rows are staged in 16 bits
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

// Shared bytes of one partition: the bases of each (tile, digit) and the
// deltas of each digit (int32), then the partition's destinations (int32)
// and rows (16 bits) by position.  Rounded up to 16 bytes.
__host__ __device__ inline size_t dest_scatter_partition_bytes(int radix, int tile,
                                                               int per_block) {
  const size_t bytes = 4 * (static_cast<size_t>(per_block) + 1) * radix +
                       6 * static_cast<size_t>(per_block) * tile;
  return (bytes + 15) / 16 * 16;
}

// Waits for the warps of the partition: its one warp, or the block.  A
// named barrier a partition, which would let a block hold several
// partitions of several tiles, makes ptxas reserve all 16 of a block's
// barriers, and was up to 4% slower on the H100 (PERF.md, Findings).
__device__ __forceinline__ void partition_sync(int per_block) {
  if (per_block == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Every staged position of the partition whose first row is `first` to its
// destination, thread i of n taking positions i, i + n, ...
template <typename T>
__device__ __forceinline__ void move_rows(const MovedColumn& c, int64_t first,
                                          const int* dst_of, const uint16_t* src_of,
                                          int count, int i, int n) {
  const T* in = static_cast<const T*>(c.src);
  T* out = static_cast<T*>(c.dst);
  if (c.units == 1) {
    for (int p0 = i; p0 < count; p0 += n * kMoveBatch) {
      T v[kMoveBatch];
      int o[kMoveBatch];
#pragma unroll
      for (int j = 0; j < kMoveBatch; ++j) {
        if (p0 + n * j < count) {
          o[j] = dst_of[p0 + n * j];
          v[j] = in[first + src_of[p0 + n * j]];
        }
      }
#pragma unroll
      for (int j = 0; j < kMoveBatch; ++j)
        if (p0 + n * j < count) out[o[j]] = v[j];
    }
  } else {  // consecutive threads take consecutive units of the staged rows
    const int64_t w = c.units;
    for (int64_t q = i; q < count * w; q += n) {
      const int p = static_cast<int>(q / w);
      const int64_t k = q - p * w;
      out[dst_of[p] * w + k] = in[(first + src_of[p]) * w + k];
    }
  }
}

// Items j0 .. j0 + kRankBatch - 1 of a warp's tile (those below `items`),
// lane l's item j being element 32 j + l: src points at the tile's element l.
__device__ __forceinline__ void load_batch(uint32_t (&k)[kRankBatch], const uint32_t* src,
                                           int j0, int items) {
#pragma unroll
  for (int j = 0; j < kRankBatch; ++j)
    if (j0 + j < items) k[j] = __ldg(src + 32 * (j0 + j));
}

// A table word by a coherent load (grs::load_global), which ptxas keeps
// where it stands instead of sinking it past a barrier to its use.
__device__ __forceinline__ int load_table(const int32_t* p) {
  return static_cast<int>(grs::load_global(reinterpret_cast<const uint32_t*>(p)));
}

template <int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    dest_scatter_kernel(const uint32_t* __restrict__ keys, const int32_t* __restrict__ hist,
                        const int32_t* __restrict__ offsets, const MovedColumns cols,
                        int64_t num_tiles, int tile, int per_block, int shift) {
  constexpr int kRadix = 1 << kBits;
  constexpr uint32_t kMask = kRadix - 1;
  constexpr int kDigitsPer = kRadix > 32 ? kRadix / 32 : 1;  // a thread's digits, at most
  extern __shared__ __align__(16) unsigned char staging[];
  const int part = 32 * per_block;  // the partition's threads
  const int group = threadIdx.x / part;
  const int me = threadIdx.x - group * part;
  const int warp = me >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t t0 =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x / part) + group) * per_block;
  if (t0 >= num_tiles) return;  // the whole partition: no other waits for it
  const int live = static_cast<int>(num_tiles - t0 < per_block ? num_tiles - t0 : per_block);

  int* base = reinterpret_cast<int*>(
      staging + group * dest_scatter_partition_bytes(kRadix, tile, per_block));
  int* delta = base + per_block * kRadix;  // [radix]
  int* dst_of = delta + kRadix;            // [per_block * tile]
  uint16_t* src_of = reinterpret_cast<uint16_t*>(dst_of + per_block * tile);

  // The warp's first batch of keys, K1's rows of the partition (zero past
  // the last tile; a thread's share is radix / 32 words at most) and the
  // first tile's offsets, all loaded at once before the first barrier, so
  // that the warp waits for device memory once here, as a warp without
  // barriers does, and not once for the tables and again for its keys.
  const bool ranks = warp < live;
  const uint32_t* src = keys + (t0 + (ranks ? warp : 0)) * tile + lane;
  const int items = tile >> 5;
  uint32_t k[kRankBatch];
  if (ranks) load_batch(k, src, 0, items);
  int counts[kDigitsPer], first_row[kDigitsPer];
#pragma unroll
  for (int i = 0; i < kDigitsPer; ++i) {
    const int e = me + i * part;  // a (tile, digit) of the partition, and a digit
    counts[i] = e < live * kRadix ? load_table(hist + t0 * kRadix + e) : 0;
    first_row[i] = e < kRadix ? load_table(offsets + t0 * kRadix + e) : 0;
  }

  // 1. The position base and the delta of each digit.  A tile alone at
  // radix <= 32 keeps them in lane registers, from one warp scan of its K1
  // row, as K4 does.  Otherwise, in shared memory: per digit its count in
  // the partition's earlier tiles and, in delta, its total; warp 0 scans the
  // totals into the partition's starts; then base += start and delta =
  // offsets[t0] - start.
  int run = 0, dl = 0;  // radix <= 32: lane r's next position and delta of digit r
  if (kRadix <= kRegisterRadix && per_block == 1) {
    int total;
    run = grs::warp_exclusive_scan(counts[0], lane, total);
    dl = first_row[0] - run;
  } else {
#pragma unroll
    for (int i = 0; i < kDigitsPer; ++i)
      if (me + i * part < per_block * kRadix) base[me + i * part] = counts[i];
    partition_sync(per_block);
    for (int d = me; d < kRadix; d += part) {
      int sum = 0;
      for (int t = 0; t < per_block; ++t) {
        const int h = base[t * kRadix + d];
        base[t * kRadix + d] = sum;
        sum += h;
      }
      delta[d] = sum;
    }
    partition_sync(per_block);
    if (warp == 0) {
      int h[kDigitsPer], sum = 0;  // lane's consecutive digits
#pragma unroll
      for (int i = 0; i < kDigitsPer; ++i) {
        const int d = lane * kDigitsPer + i;
        h[i] = d < kRadix ? delta[d] : 0;
        sum += h[i];
      }
      int total;
      int start = grs::warp_exclusive_scan(sum, lane, total);
#pragma unroll
      for (int i = 0; i < kDigitsPer; ++i) {
        const int d = lane * kDigitsPer + i;
        if (d < kRadix) delta[d] = start;
        start += h[i];
      }
    }
    partition_sync(per_block);
#pragma unroll
    for (int i = 0; i < kDigitsPer; ++i) {
      const int d = me + i * part;
      if (d < kRadix) {
        const int start = delta[d];
        for (int t = 0; t < per_block; ++t) base[t * kRadix + d] += start;
        delta[d] = first_row[i] - start;
      }
    }
    partition_sync(per_block);
    if (kRadix <= kRegisterRadix && ranks && lane < kRadix) {
      run = base[warp * kRadix + lane];
      dl = delta[lane];
    }
  }

  // 2. Rank step: warp w ranks the partition's tile w.
  if (ranks) {
    int* next = base + warp * kRadix;  // radix > 32: digit d's next position in this tile
    const unsigned below = (1u << lane) - 1u;
    for (int j0 = 0; j0 < items; j0 += kRankBatch) {
      if (j0 > 0) load_batch(k, src, j0, items);
#pragma unroll
      for (int j = 0; j < kRankBatch; ++j) {
        if (j0 + j < items) {  // alike in every lane
          const uint32_t d = (k[j] >> shift) & kMask;
          const grs::DigitBallots<kBits> ballots(d, kBits);
          const unsigned peers = ballots.lanes_with(d, kBits);
          const int rank = __popc(peers & below);
          int pos, off;
          if constexpr (kRadix <= kRegisterRadix) {
            pos = __shfl_sync(grs::kFullWarp, run, d) + rank;
            off = __shfl_sync(grs::kFullWarp, dl, d);
            run += __popc(ballots.lanes_with(lane, kBits));
          } else {  // the group's lowest lane reads and advances its digit's slot
            int slot = 0;
            if (rank == 0) {
              slot = next[d];
              next[d] = slot + __popc(peers);
            }
            __syncwarp();
            pos = __shfl_sync(grs::kFullWarp, slot, __ffs(peers) - 1) + rank;
            off = delta[d];
          }
          dst_of[pos] = pos + off;
          src_of[pos] = static_cast<uint16_t>(warp * tile + 32 * (j0 + j) + lane);
        }
      }
    }
  }
  partition_sync(per_block);

  // 3. Move step: every column, by the width of its unit.
  const int64_t first = t0 * tile;
  const int count = live * tile;
  for (int c = 0; c < cols.count; ++c) {
    const MovedColumn& col = cols.col[c];
    switch (col.unit) {
      case 16: move_rows<uint4>(col, first, dst_of, src_of, count, me, part); break;
      case 8: move_rows<uint2>(col, first, dst_of, src_of, count, me, part); break;
      case 4: move_rows<uint32_t>(col, first, dst_of, src_of, count, me, part); break;
      case 2: move_rows<uint16_t>(col, first, dst_of, src_of, count, me, part); break;
      default: move_rows<uint8_t>(col, first, dst_of, src_of, count, me, part); break;
    }
  }
}

// Launches the instance of `radix` (a power of two, 2 to 256); above 48 KB of
// shared memory, after opting in to it.
template <int kBits>
cudaError_t launch_dest_scatter(int radix, dim3 grid, int threads, size_t smem,
                                cudaStream_t s, const uint32_t* keys, const int32_t* hist,
                                const int32_t* offsets, const MovedColumns& cols,
                                int64_t num_tiles, int tile, int per_block, int shift) {
  if (radix != 1 << kBits) {
    if constexpr (kBits > 1) {
      return launch_dest_scatter<kBits - 1>(radix, grid, threads, smem, s, keys, hist,
                                            offsets, cols, num_tiles, tile, per_block, shift);
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
                                                         tile, per_block, shift);
  return cudaGetLastError();
}

}  // namespace

// keys: num_tiles * tile uint32, the rank source (4-byte aligned); hist and
// offsets: (num_tiles, radix) int32, K1's table and global_offsets of it
// (only each partition's first row of the offsets is read).  columns:
// num_columns (1 to 8) descriptors of four int64 words each, read here
// before the launch: the source's and the destination's address, the units
// a row and the bytes a unit (1, 2, 4, 8 or 16; both addresses aligned to
// it); every column has num_tiles * tile rows, and no destination overlaps a
// source or another destination.  A partition is per_block tiles (1 to 8,
// per_block x tile at most 2^16), one warp each; a block of threads (32 to
// 256) is one partition, or threads / 32 partitions of one tile; tile is a
// multiple of 128; radix a power of two from 2 to 256.  A block keeps
// dest_scatter_partition_bytes a partition in shared memory, at most
// 232,448 bytes.  Returns the launch's error, or cudaGetLastError() after it.
extern "C" int grs_radix_dest_scatter(const void* keys, const void* hist, const void* offsets,
                                      const int64_t* columns, int num_columns,
                                      int64_t num_tiles, int tile, int threads, int per_block,
                                      int shift, int radix, void* stream) {
  if (radix < 2 || radix > kMaxRadix || (radix & (radix - 1)) != 0 ||
      threads < 32 || threads % 32 != 0 || threads > 32 * kMaxWarps || tile <= 0 ||
      tile % 128 != 0 || per_block < 1 || per_block > kMaxPartition ||
      (per_block > 1 && threads != 32 * per_block) ||
      static_cast<int64_t>(per_block) * tile > kMaxPartitionRows ||
      num_columns < 1 || num_columns > kMaxColumns) {
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
  const int partitions = threads / (32 * per_block);  // a block's
  const size_t smem = partitions * dest_scatter_partition_bytes(radix, tile, per_block);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const int64_t per_grid_block = static_cast<int64_t>(partitions) * per_block;
  const dim3 grid(static_cast<unsigned>((num_tiles + per_grid_block - 1) / per_grid_block));
  return static_cast<int>(launch_dest_scatter<8>(
      radix, grid, threads, smem, static_cast<cudaStream_t>(stream),
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(hist),
      static_cast<const int32_t*>(offsets), cols, num_tiles, tile, per_block, shift));
}
