// The join's probe: each probe key's lower bound among the build side's
// sorted keys, and whether the key is there, in one launch.
//
// Replaces no Pallas kernel.  The JAX package probes with jnp.searchsorted
// (gpuradixsort_tpu/ops/join.py's join), clips the positions and compares
// the build key at each.  The port ran that as torch's int64 searchsorted
// over int64 copies of both padded key columns, a clamp, an index of the
// build keys, a compare and the filter's int32 cast of the mask: passes over
// the whole padded probe, and a search of every pad row.
//
// This kernel reads the probe's uint32 keys as they lie and searches only
// the rows below the probe's live length `live`, rounded up to a tile of
// kTileRows rows.  For every row i of the n it writes
//   pos[i]  = the lower bound of key[i] among the nb build keys, compared
//             unsigned and clipped to [0, max(nb - 1, 0)], int32; only where
//             positions are asked for (an inner join's payload gather);
//   keep[i] = int32 0/1, pos < nb && build[pos] == key[i], negated for an
//             anti join.
// The rows from `live` on are searched as PAD_KEY and are pads: pos is the
// clipped lower bound of PAD_KEY, found once a block, and keep is 0, both
// stored with no key read.  With nb = 0, pos is 0 and no key matches.
//
// Bound on the H100: HBM bytes at 3.35 TB/s,
//   live x (4 key + 4 keep + 4 pos) + (n - live) x (4 keep + 4 pos) + 4 nb
// (no pos bytes where positions are not asked for), each build key read
// once: the searches' dependent loads land in the L2, which holds a build
// side of 4.4M keys (17.6 MB) whole.
//
// Design:
//   1. Persistent blocks (as many as the card holds at once) that search
//      stage a splitter table in dynamic shared memory: build[j << shift]
//      for j < T.  A build side of at most kMaxTable keys is staged whole
//      (shift 0), and its searches read nothing else; a larger one takes the
//      least stride 2^shift, from 8 on, that keeps T <= kMaxTable.  The
//      table is T keys, not kMaxTable.  A block of 512 threads is one an SM
//      (its registers), so an SM holds one copy of the table, and the rest
//      of its 256 KB of shared memory and L1 caches the sectors of the
//      upper halving steps: a random probe of 97M rows into 4.4M keys took
//      4.42 ms so, and 6.26 ms with three blocks of 256 threads an SM,
//      three copies and little L1 (NVIDIA H100, PERF.md).
//   2. A block walks tiles of kTileRows rows; thread t takes rows t, t +
//      kThreads, ... of a tile, kSearches of them, so a warp's key loads and
//      its stores are coalesced.  A thread runs its kSearches searches in
//      lockstep: a level's loads all start before any is used, to hide
//      the L2's latency (asm volatile loads, which ptxas keeps in
//      place; it sinks an ld.global.nc it can see to its one use).
//   3. A search is a lower bound with a fixed number of steps: over the
//      table (c = the splitters below the key, bit_length(T) steps), then,
//      where shift > 0, by halving the window of 2^shift keys from splitter
//      c - 1 on down to 8 keys (shift - 3 loads through the read-only path),
//      and last by one read of the window's 32-byte sector, whose keys below
//      the probe key are counted in registers.  Each halving that moves
//      down keeps the key it read as the window's upper end, so the match
//      is decided without another load.  A random probe into a build side
//      too large for an SM's L1 thus costs shift - 2 sectors from the L2,
//      not shift + 1.  Nothing assumes sorted probes; sorted ones land on
//      neighbouring splitters and sectors, and their loads coalesce.
//   4. Then every block writes its share of the rows from the first tile
//      past `live` to n by 16-byte stores.
// The grid follows the host's live length: no host sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;                    // a block's
constexpr int kSearches = 4;                     // probe rows a thread searches at once
constexpr int kTileRows = kThreads * kSearches;  // kernels/probe.py's TILE_ROWS
constexpr int kMaxTable = 32768;  // splitters a block stages at most: 128 KB, dynamic
constexpr int kFillChunks = 4;    // 16-byte stores a thread makes in the fill, at least
constexpr uint32_t kPadKey = 0xFFFFFFFFu;

// Passed by value as a launch parameter.
struct Probe {
  const uint32_t* keys;
  const uint32_t* build;
  int32_t* pos;  // null where positions are not asked for
  int32_t* keep;
  int64_t n;
  int64_t live;
  int64_t walk_end;  // live rounded up to a tile, at most n: the rows searched
  uint32_t nb;
  int shift;        // log2 of the splitters' stride
  uint32_t table;   // splitters staged: ceil(nb / 2^shift)
  int table_steps;  // bit_length(table)
  bool negate;
  bool vector;  // build is 32-byte aligned: its sectors are read whole
};

__device__ __forceinline__ uint32_t load_nc(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t at_most(uint32_t a, uint32_t b) { return a < b ? a : b; }

// One branch-free step of a lower bound over [lo, lo + len): v is the value
// at lo + len / 2 (any value where len is 0).
__device__ __forceinline__ void step(uint32_t& lo, uint32_t& len, uint32_t v, uint32_t key) {
  const uint32_t half = len >> 1;
  const bool right = len > 0 && v < key;
  lo = right ? lo + half + 1 : lo;
  len = right ? len - half - 1 : half;
}

// The clipped lower bound of PAD_KEY among the nb >= 1 build keys.
__device__ int32_t pad_position(const uint32_t* build, uint32_t nb) {
  if (build[nb - 1] != kPadKey) return static_cast<int32_t>(nb - 1);
  uint32_t lo = 0, len = nb - 1;  // build[nb - 1] is PAD_KEY: the bound lies in [0, nb - 1]
  while (len > 0) step(lo, len, build[lo + (len >> 1)], kPadKey);
  return static_cast<int32_t>(lo);
}

// The 8 keys build[base .. base + 8) (base a multiple of 8), those at or past
// nb read as PAD_KEY where they are not read at all: by two 16-byte loads
// of one 32-byte sector where the build keys are 32-byte aligned (no byte
// of the sector lies past the allocation that holds build[nb - 1]), else
// key by key.
__device__ __forceinline__ void load_sector(const uint32_t* build, uint32_t base, uint32_t nb,
                                            bool vector, uint32_t (&w)[8]) {
  if (vector) {
    const uint32_t* p = build + base;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p) : "memory");
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[4]), "=r"(w[5]), "=r"(w[6]), "=r"(w[7]) : "l"(p + 4) : "memory");
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) w[t] = base + t < nb ? load_nc(build + base + t) : kPadKey;
  }
}

// The rows row0, row0 + kThreads, ... of a tile: searched below `live`,
// written as pads from `live` to n.
__device__ __forceinline__ void search_rows(const Probe& p, const uint32_t* table, int64_t row0,
                                            int32_t pad_pos) {
  uint32_t key[kSearches], lo[kSearches], len[kSearches], hi[kSearches];
  bool live[kSearches], matched[kSearches], hi_in[kSearches];
#pragma unroll
  for (int j = 0; j < kSearches; ++j) {
    const int64_t r = row0 + static_cast<int64_t>(j) * kThreads;
    live[j] = r < p.live;
    key[j] = live[j] ? load_nc(p.keys + r) : 0u;
    lo[j] = 0;
    len[j] = p.table;
    matched[j] = false;
  }
  if (p.nb > 0) {
    for (int s = 0; s < p.table_steps; ++s) {  // c: the splitters below the key
      uint32_t v[kSearches];
#pragma unroll
      for (int j = 0; j < kSearches; ++j)
        v[j] = table[at_most(lo[j] + (len[j] >> 1), p.table - 1)];
#pragma unroll
      for (int j = 0; j < kSearches; ++j) step(lo[j], len[j], v[j], key[j]);
    }
    if (p.shift == 0) {  // the table is the build side: the bound is c
#pragma unroll
      for (int j = 0; j < kSearches; ++j)
        matched[j] = lo[j] < p.nb && table[at_most(lo[j], p.nb - 1)] == key[j];
    } else {
      // c > 0: the bound lies in (base, base + len], build[base] < key, and
      // hi is build[base + len] where hi_in (base + len < nb).  c = 0: the
      // bound is 0, build[0] = table[0].
#pragma unroll
      for (int j = 0; j < kSearches; ++j) {
        const uint32_t c = lo[j];
        matched[j] = c == 0 && table[0] == key[j];
        hi_in[j] = c < p.table;
        hi[j] = table[at_most(c, p.table - 1)];
        lo[j] = c ? (c - 1) << p.shift : 0;
        len[j] = c ? 1u << p.shift : 0;
      }
      for (int s = 3; s < p.shift; ++s) {  // halve the window down to 8 keys
        uint32_t v[kSearches];
#pragma unroll
        for (int j = 0; j < kSearches; ++j)
          v[j] = load_nc(p.build + at_most(lo[j] + (len[j] >> 1), p.nb - 1));
#pragma unroll
        for (int j = 0; j < kSearches; ++j) {
          const uint32_t m = lo[j] + (len[j] >> 1);
          if (len[j] && m < p.nb && v[j] < key[j]) {
            lo[j] = m;
          } else {
            hi[j] = v[j];
            hi_in[j] = m < p.nb;
          }
          len[j] >>= 1;
        }
      }
      uint32_t w[kSearches][8];
#pragma unroll
      for (int j = 0; j < kSearches; ++j) load_sector(p.build, lo[j], p.nb, p.vector, w[j]);
#pragma unroll
      for (int j = 0; j < kSearches; ++j) {
        if (!len[j]) continue;  // c = 0
        uint32_t below = 0;
        bool equal = false;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const bool in = lo[j] + t < p.nb;
          below += in && w[j][t] < key[j];
          equal |= in && w[j][t] == key[j];
        }
        matched[j] = equal || (below == 8 && hi_in[j] && hi[j] == key[j]);
        lo[j] += below;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSearches; ++j) {
    const int64_t r = row0 + static_cast<int64_t>(j) * kThreads;
    if (r >= p.n) break;
    p.keep[r] = live[j] ? (matched[j] != p.negate) : 0;
    if (p.pos) p.pos[r] = live[j] ? static_cast<int32_t>(at_most(lo[j], p.nb - 1)) : pad_pos;
  }
}

// The rows [walk_end, n) as pads, 16-byte stores: thread `me` of `threads`
// takes chunks of 4 rows me, me + threads, ...
__device__ __forceinline__ void fill_rows(const Probe& p, int32_t pad_pos, int64_t me,
                                          int64_t threads) {
  const int64_t rows = p.n - p.walk_end;
  const int64_t chunks = rows / 4;
  int4* keep = reinterpret_cast<int4*>(p.keep + p.walk_end);  // 16-byte aligned
  int4* pos = p.pos ? reinterpret_cast<int4*>(p.pos + p.walk_end) : nullptr;
  const int4 zero = make_int4(0, 0, 0, 0);
  const int4 pad = make_int4(pad_pos, pad_pos, pad_pos, pad_pos);
  for (int64_t q = me; q < chunks; q += threads) {
    keep[q] = zero;
    if (p.pos) pos[q] = pad;
  }
  for (int64_t e = 4 * chunks + me; e < rows; e += threads) {
    p.keep[p.walk_end + e] = 0;
    if (p.pos) p.pos[p.walk_end + e] = pad_pos;
  }
}

__global__ void __launch_bounds__(kThreads) join_probe_kernel(const Probe p) {
  extern __shared__ uint32_t table[];  // p.table splitters, staged where the block searches
  __shared__ int32_t pad_pos;
  const int64_t first = blockIdx.x * static_cast<int64_t>(kTileRows);
  if (first < p.walk_end) {
    for (uint32_t j = threadIdx.x; j < p.table; j += kThreads)
      table[j] = p.build[static_cast<int64_t>(j) << p.shift];
  }
  if (threadIdx.x == 0) pad_pos = p.pos && p.nb > 0 ? pad_position(p.build, p.nb) : 0;
  __syncthreads();
  for (int64_t t0 = first; t0 < p.walk_end; t0 += gridDim.x * static_cast<int64_t>(kTileRows))
    search_rows(p, table, t0 + threadIdx.x, pad_pos);
  fill_rows(p, pad_pos, blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x,
            gridDim.x * static_cast<int64_t>(kThreads));
}

}  // namespace

// keys: n uint32 probe keys, of which the first `live` (0 <= live <= n) are
// read; build: nb (< 2^31) uint32 keys sorted ascending; keep: n int32,
// 16-byte aligned; pos: n int32, 16-byte aligned, or null for none; negate:
// non-zero for an anti join.  No output overlaps an input.  Returns the
// launch's error, or cudaGetLastError() after it.
extern "C" int grs_join_probe(const void* keys, int64_t n, int64_t live, const void* build,
                              int64_t nb, void* pos, void* keep, int negate, void* stream) {
  if (n < 0 || live < 0 || live > n || nb < 0 || nb > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(keep) % 16 != 0 || reinterpret_cast<uintptr_t>(pos) % 16 != 0 ||
      (n > 0 && keep == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int shift = nb > kMaxTable ? 3 : 0;  // a stride of 2 or 4 leaves no sector to read
  while (((nb + (int64_t{1} << shift) - 1) >> shift) > kMaxTable) ++shift;
  const uint32_t table = static_cast<uint32_t>((nb + (int64_t{1} << shift) - 1) >> shift);
  int table_steps = 0;
  while ((table >> table_steps) != 0) ++table_steps;
  const int64_t rounded = (live + kTileRows - 1) / kTileRows * kTileRows;
  const int64_t walk_end = rounded < n ? rounded : n;
  const int64_t tiles = (walk_end + kTileRows - 1) / kTileRows;

  const size_t smem = table * sizeof(uint32_t);
  static int cached_device = -1, sms = 0;
  int device = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != cached_device) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(join_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kMaxTable * static_cast<int>(sizeof(uint32_t)))) !=
            cudaSuccess) {
      return static_cast<int>(err);
    }
    cached_device = device;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, join_probe_kernel, kThreads,
                                                           smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // Persistent blocks: as many as the card holds at once, at most one a tile
  // or a fill block's share of the pad rows, whichever asks for more.
  const int64_t most = static_cast<int64_t>(resident > 0 ? resident : 1) * sms;
  const int64_t per_fill_block = static_cast<int64_t>(kThreads) * 4 * kFillChunks;
  const int64_t fills = (n - walk_end + per_fill_block - 1) / per_fill_block;
  int64_t blocks = tiles > fills ? tiles : fills;
  if (blocks > most) blocks = most;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const Probe p{static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(build),
                static_cast<int32_t*>(pos), static_cast<int32_t*>(keep), n, live, walk_end,
                static_cast<uint32_t>(nb), shift, table, table_steps,
                negate != 0, reinterpret_cast<uintptr_t>(build) % 32 == 0};
  join_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
