// The payload gather: a column pulled through an index,
// out[i] = v[clip(src[i], 0, rows - 1)].
//
// Replaces no Pallas kernel.  The JAX package gathers the payload columns of
// a sort and of a join with jnp.take (gpuradixsort_tpu/ops/sort.py's
// sort_table, ops/join.py), which XLA lowers to a gather; the port ran each
// column as torch's index_select of an int64 copy of the index, clamped
// (ops/permute.py::gather_rows, which the plain references keep): three
// passes over the index a column, over the whole padded buffer where a
// sort's permutation R holds few live rows.  This kernel reads the index as
// it lies (int32 or int64), clips it in registers, and reads it only for the
// rows below `live`: the rows from `live` on are the column's row 0, which
// is what R's PAD_INDEX (-1 as int32, clipped to 0) gathers, written with no
// read of the index.
//
// One column a launch.  On the H100, q3's two join payloads (180M random
// int64 positions into 4.4M rows, 17.6 MB a column) took 4910.8 us in one
// launch that moved both and 3357.8 in a launch a column: a random gather
// reads its source from L2 where it fits, and two columns read by the same
// warps halve the L2 each keeps.  A permutation of few live rows (a
// top-k's) costs the same either way (910.7 and 915.2 us for 4 columns of
// 180M rows, 300K live), and all live rows of 100M as much (3319.7, 3320.0).
//
// Bound on the H100: HBM bytes at 3.35 TB/s,
//   live x (index bytes + row bytes read + row bytes written)
//   + (n - live) x row bytes written.
// A read at a random row moves a whole 32-byte sector; the bound counts the
// row's own bytes, each input byte once.
//
// Design:
//   1. Gather blocks, one warp a run of kRunRows (128) consecutive rows,
//      cover the rows below `live`, rounded up to a run.  Lane l loads the
//      run's indices 4l .. 4l + 3 with one 16-byte load (two for int64)
//      where the index is 16-byte aligned and the four lie below `live`,
//      else one by one; rows at or past `live` take row 0 (the straddling
//      run's rows past the last live row).  The warp stages its run's
//      indices in shared memory, 8 bytes a row.
//   2. Consecutive lanes take consecutive units of the run's output rows,
//      so a warp's store is one contiguous stretch.  A unit is the widest of
//      16, 8, 4, 2 and 1 bytes that divides the row and both addresses;
//      units narrower than 4 bytes are packed into 4-byte words, a lane
//      storing a word.  A lane loads a batch of units before it stores them
//      (plain pointers, which may alias, so the compiler keeps the loads
//      ahead of the stores).  Reads through a near-sorted index (R of
//      near-sorted keys, a join's monotone positions) land on neighbouring
//      rows and coalesce in the warp; nothing more is staged.
//   3. Fill blocks, after the gather blocks, write the rows from the first
//      run past `live` to n: row 0 repeated, by 16-byte stores (the output
//      is 16-byte aligned and a run starts at a multiple of 128 rows), the
//      last bytes one by one.
// The grid follows the host's live length: no host sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // a block's
constexpr int kWarps = kThreads / 32;
constexpr int kRunRows = 128;     // rows a warp gathers: 4 a lane
constexpr int kBatch = 8;         // units (or words) a lane loads before it stores them
constexpr int kMaxUnitsRow = 1 << 20;  // units a row, at most: a run's units fit an int
constexpr int kMaxFillBlocks = 1056;   // 8 an H100 SM
constexpr int kFillChunks = 4;         // 16-byte stores a fill thread makes, at least

// Passed by value as a launch parameter, so a captured graph holds its own copy.
struct GatherColumn {
  const void* src;
  void* dst;
  int64_t rows;   // the source's rows: the index is clipped to them
  int64_t units;  // units a row
  int64_t unit;   // bytes a unit: 1, 2, 4, 8 or 16
};

__device__ __forceinline__ int64_t clip(int64_t r, int64_t last) {
  return r < 0 ? 0 : (r > last ? last : r);
}

// The indices of rows first .. first + 3, each 16-byte aligned group by one
// load (two for int64) where `vector`; rows at or past `live` are 0.
template <typename Index>
__device__ __forceinline__ void load_indices(const Index* index, bool vector, int64_t first,
                                             int64_t live, int64_t (&r)[4]) {
  if (vector && first + 4 <= live) {
    if constexpr (sizeof(Index) == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(index + first));
      r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
    } else {
      const longlong2* p = reinterpret_cast<const longlong2*>(index + first);
      const longlong2 a = __ldg(p), b = __ldg(p + 1);
      r[0] = a.x, r[1] = a.y, r[2] = b.x, r[3] = b.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      r[t] = first + t < live ? static_cast<int64_t>(index[first + t]) : 0;
  }
}

// The column's `count` rows of the run at `run0`, units of 4 bytes or more: lane
// `lane` takes units lane, lane + 32, ... of the run's output.
template <typename T>
__device__ __forceinline__ void gather_units(const GatherColumn& c, const int64_t* staged,
                                             int64_t run0, int count, int lane) {
  const T* in = static_cast<const T*>(c.src);
  const int w = static_cast<int>(c.units);
  T* out = static_cast<T*>(c.dst) + run0 * w;
  const int64_t last = c.rows - 1;
  const int total = count * w;
  for (int q0 = lane; q0 < total; q0 += 32 * kBatch) {
    T v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = q0 + 32 * j;
      if (q < total) {
        const int p = w == 1 ? q : q / w;
        v[j] = in[clip(staged[p], last) * w + (q - p * w)];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (q0 + 32 * j < total) out[q0 + 32 * j] = v[j];
  }
}

// The same for units of 1 or 2 bytes, packed: lane `lane` stores 4-byte words
// lane, lane + 32, ...; the units of a last word that the column's end cuts
// are stored one by one.
template <typename T>
__device__ __forceinline__ void gather_words(const GatherColumn& c, const int64_t* staged,
                                             int64_t run0, int count, int lane) {
  constexpr int kPer = 4 / sizeof(T);
  const T* in = static_cast<const T*>(c.src);
  const int w = static_cast<int>(c.units);
  T* out = static_cast<T*>(c.dst) + run0 * w;  // 4-byte aligned: 128 rows of whole units
  const int64_t last = c.rows - 1;
  const int total = count * w;
  const int words = total / kPer;
  for (int q0 = lane; q0 < words; q0 += 32 * kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = q0 + 32 * j;
      if (q < words) {
        uint32_t word = 0;
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
          const int e = q * kPer + t;
          const int p = w == 1 ? e : e / w;
          const uint32_t u = in[clip(staged[p], last) * w + (e - p * w)];
          word |= u << (8 * sizeof(T) * t);
        }
        v[j] = word;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (q0 + 32 * j < words) reinterpret_cast<uint32_t*>(out)[q0 + 32 * j] = v[j];
  }
  for (int e = words * kPer + lane; e < total; e += 32) {
    const int p = e / w;
    out[e] = in[clip(staged[p], last) * w + (e - p * w)];
  }
}

// 16 bytes of row 0 (b bytes) repeated, from its byte `at` on.
__device__ __forceinline__ uint4 repeated_row(const uint8_t* row0, int64_t b, int64_t at) {
  uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    word[j >> 2] |= static_cast<uint32_t>(row0[at]) << (8 * (j & 3));
    at = at + 1 == b ? 0 : at + 1;
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// The column's rows [from, n) as its row 0: 16-byte stores, thread `me` of
// `threads` taking chunks me, me + threads, ...
__device__ __forceinline__ void fill_rows(const GatherColumn& c, int64_t from, int64_t n,
                                          int64_t me, int64_t threads) {
  const int64_t b = c.units * c.unit;
  const uint8_t* row0 = static_cast<const uint8_t*>(c.src);
  uint8_t* base = static_cast<uint8_t*>(c.dst) + from * b;  // 16-byte aligned
  const int64_t bytes = (n - from) * b;
  const int64_t chunks = bytes / 16;
  uint4* out = reinterpret_cast<uint4*>(base);
  if (16 % b == 0) {  // every chunk is the same 16 bytes
    const uint4 v = repeated_row(row0, b, 0);
    for (int64_t q = me; q < chunks; q += threads) out[q] = v;
  } else {  // chunk q starts at byte 16 q mod b of row 0
    for (int64_t q = me; q < chunks; q += threads) out[q] = repeated_row(row0, b, 16 * q % b);
  }
  for (int64_t e = 16 * chunks + me; e < bytes; e += threads) base[e] = row0[e % b];
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const Index* __restrict__ index, bool vector, const GatherColumn col,
                       int64_t n, int64_t live, int64_t gather_blocks) {
  __shared__ int64_t staged[kWarps][kRunRows];
  if (blockIdx.x >= gather_blocks) {
    const int64_t from = (live + kRunRows - 1) / kRunRows * kRunRows;
    const int64_t threads = (gridDim.x - gather_blocks) * static_cast<int64_t>(kThreads);
    const int64_t me = (blockIdx.x - gather_blocks) * static_cast<int64_t>(kThreads) + threadIdx.x;
    fill_rows(col, from, n, me, threads);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t run0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kRunRows;
  if (run0 >= live) return;  // a warp's own rows; no block barrier follows
  int64_t* rows = staged[warp];
  int64_t r[4];
  load_indices(index, vector, run0 + 4 * lane, live, r);
#pragma unroll
  for (int t = 0; t < 4; ++t) rows[4 * lane + t] = r[t];
  __syncwarp();
  const int count = static_cast<int>(n - run0 < kRunRows ? n - run0 : kRunRows);
  switch (col.unit) {
    case 16: gather_units<uint4>(col, rows, run0, count, lane); break;
    case 8: gather_units<uint2>(col, rows, run0, count, lane); break;
    case 4: gather_units<uint32_t>(col, rows, run0, count, lane); break;
    case 2: gather_words<uint16_t>(col, rows, run0, count, lane); break;
    default: gather_words<uint8_t>(col, rows, run0, count, lane); break;
  }
}

}  // namespace

// index: n int32 (index_bytes 4) or int64 (8) row numbers; rows below `live`
// (0 <= live <= n) are read, clipped to the source's `rows` (at least 1).
// src: the source, `units` (1 to 2^20) units a row of `unit` bytes (1, 2, 4,
// 8 or 16; src aligned to it); dst: n rows, 16-byte aligned, overlapping
// neither src nor the index.  Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int grs_gather_rows(const void* index, int index_bytes, int64_t n, int64_t live,
                               const void* src, int64_t rows, int64_t units, int64_t unit,
                               void* dst, void* stream) {
  if ((index_bytes != 4 && index_bytes != 8) || n < 0 || live < 0 || live > n ||
      (unit != 1 && unit != 2 && unit != 4 && unit != 8 && unit != 16) || rows < 1 ||
      units < 1 || units > kMaxUnitsRow || reinterpret_cast<uintptr_t>(src) % unit != 0 ||
      reinterpret_cast<uintptr_t>(dst) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GatherColumn col{src, dst, rows, units, unit};
  const int64_t from = (live + kRunRows - 1) / kRunRows * kRunRows;
  const int64_t fill_bytes = from < n ? (n - from) * units * unit : 0;
  const int64_t runs = (live + kRunRows - 1) / kRunRows;
  const int64_t gather_blocks = (runs + kWarps - 1) / kWarps;
  const int64_t per_fill_block = static_cast<int64_t>(kThreads) * 16 * kFillChunks;
  int64_t fill_blocks = (fill_bytes + per_fill_block - 1) / per_fill_block;
  if (fill_blocks > kMaxFillBlocks) fill_blocks = kMaxFillBlocks;
  const int64_t blocks = gather_blocks + fill_blocks;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool vector = reinterpret_cast<uintptr_t>(index) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 4) {
    gather_rows_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(index), vector, col, n, live, gather_blocks);
  } else {
    gather_rows_kernel<int64_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int64_t*>(index), vector, col, n, live, gather_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
