// The fused sort's pass: bucketize and scatter (K2 then K3) as one kernel.
//
// Replaces, on the fused sort's main path, the pair of Pallas kernels
// gpuradixsort_tpu/kernels/bucketize.py::_bucketize_kernel and
// gpuradixsort_tpu/kernels/scatter.py::_window_kernel, which one fused pass
// runs one after the other (gpuradixsort_tpu/ops/sort.py:88-92).  The output
// equals scatter_runs(bucketize_tiles(keys, idx, shift), hist, offsets) for
// hist the tiles' digit histograms (K1's): tile t's digit-r run, stably in
// element order, goes to out[offsets[t, r] ...].
//
// Bound on the H100: HBM bytes, 16 a key: key and index each read once and
// written once, plus each tile's offsets row (from a table) or its status
// words, written and read once (by look-back).  The TPU pair writes the
// bucketized tiles to HBM and reads them back, because the TPU has no random
// store; K2 and K3 ported that boundary and moved 32 bytes a key between
// them.  Here the bucketized tile stays in the warp's shared memory.
//
// Design: one warp a tile and no block barrier, as K2 and K3.  For the
// default 1,024-key tile (bucketize_scatter_1k_kernel) a warp
//   1. loads the tile warp-striped into registers (32 keys and 32 indices a
//      lane, all loads issued before the first is used), and lane r < radix
//      its entry of the tile's offsets row;
//   2. ranks it with one ballot per digit bit and stages it digit-major in
//      shared memory (grs::rank_1k, K2's step); lane r ends with the tile's
//      count of digit r, so hist is not read;
//   3. reads the staging back warp-striped and stores slot p at
//      offsets[t, r] - start[r] + p (grs::place_1k, K3's step): a store
//      instruction covers 32 neighbouring slots, one or two runs.
// The warps are not persistent, one tile a warp, as in K3: run r of tile t
// and of tile t + 1 share a 32-byte sector of the output, and tiles placed
// close in time meet in L2; persistent warps with K2's cp.async prefetch of
// the next tile measured slower (PERF.md, Findings).  Any other tile
// (bucketize_scatter_any_kernel) counts the tile from device memory, reads
// it again to stage it (grs::rank_any) and places it from the staging
// (grs::place_any).  A destination outside [0, n), possible only for an
// inconsistent offsets table, is dropped, as in K3.
//
// Two routes to a tile's run offsets, one kernel template (kLookBack):
//   - from a table: offsets[t, r], K1's histograms through global_offsets
//     (bucketize_scatter_*_kernel, grs_bucketize_scatter), the counterpart
//     of the JAX package's pair.
//   - by look-back (lookback_scatter_*_kernel, grs_lookback_scatter): run r
//     of tile t starts at base[r] + count[0, r] + ... + count[t - 1, r],
//     where base is the pass's digit bases, which key_bits.cu counts in its
//     one read of the sort's input.  The fused sort's passes run this route,
//     so a pass is this one kernel: no K1, no offsets scan (Onesweep,
//     Adinets and Merrill, "Onesweep: A Faster Least Significant Digit Radix
//     Sort for GPUs", 2022).  After its rank step a warp holds its tile's
//     count of digit r in lane r.  It publishes them in a 64-bit status word
//     a (tile, digit) (warp.cuh; tag high, value low: an inclusive prefix
//     reaches 2^31 - block, so the paper's 30-bit packing does not fit),
//     then looks back 32 tiles a round, one lane a tile, each lane loading
//     its tile's row of words: a ballot per digit over the round's tags
//     finds the nearest tile that holds an inclusive prefix of that digit,
//     one warp sum adds the counts up to it, and the tile publishes its own
//     inclusive prefixes.  A warp takes its tile number from a ticket of
//     the pass when it starts, not from blockIdx, so it only ever waits on
//     tiles whose warps have started: no deadlock, whatever the order the
//     card runs blocks in.  A tag is (pass + 1) << 2 | kind, kind 1 a
//     count and 2 an inclusive prefix, so that the words a skipped or an
//     earlier pass left read as not ready; the sort clears the words and
//     the tickets once, in key_bits.cu's memset, before its first pass, so
//     a graph's replay reads none of the last sort's.
//
// Buffers: a launch reads (keys, idx) from buffer `source` and writes buffer
// `destination` of {input, out, scratch}.  Without a plan it reads the input
// and writes out.  In a fused sort it follows the sort's pass plan
// (key_bits.cu): a skipped pass returns at once, and a pass that runs reads
// the input, the result R (out) or the scratch S and writes R or S, never
// the buffer it reads: one tile's stores would land on another tile's keys
// before that tile had read them.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kMaxRadix = 16;
constexpr int kFastTile = grs::kFastTile;
constexpr int kItems = grs::kFastItems;
constexpr int kMaxWarps = 8;        // tiles a block
constexpr int kLookBackWarps = 4;   // tiles a block by look-back
constexpr int kMaxShared = 232448;  // shared memory a block may use (H100)

// The sort's buffers: 0 the input, 1 the result (or an unplanned launch's
// output), 2 the scratch.  The input is only read.
struct Buffers {
  uint32_t* keys[3];
  uint32_t* idx[3];
};

// Buffer i's keys and indices, chosen by compares: indexing the kernel
// parameter with a value known only at run time would copy it to the stack.
struct Pair {
  uint32_t* keys;
  uint32_t* idx;
};

__device__ __forceinline__ Pair buffer(const Buffers& b, int i) {
  return i == 0 ? Pair{b.keys[0], b.idx[0]}
                : (i == 1 ? Pair{b.keys[1], b.idx[1]} : Pair{b.keys[2], b.idx[2]});
}

// The look-back route's inputs.  bases: every pass's digit bases
// (num_passes x radix int32).  counts: a 32-bit word a (tile, digit),
// (pass + 1) << 16 | count (a tile holds fewer than 2^16 keys; 0: not yet
// published).  passes: a block of words a pass, all of it zero before the
// pass (the sort clears it once): the pass's tile ticket and a spare word;
// a 64-bit word a (group of kGroup tiles, digit), to which each tile of the
// group adds 1 << 32 | its count, so that the high half counts the tiles
// that added and the low half holds their sum; and a 32-bit word a (group,
// digit), kInclusive | the inclusive prefix at the group's end once its
// last tile knows it.
struct LookBack {
  const int32_t* bases;
  uint32_t* counts;
  uint32_t* passes;
  int64_t num_groups;
};

constexpr int kGroup = 32;                    // tiles a group
constexpr uint32_t kInclusive = 0x80000000u;  // prefixes stay below 2^31

// One pass's words of the look-back.
struct PassWords {
  uint32_t* ticket;
  unsigned long long* sums;
  uint32_t* inclusive;
};

__device__ __forceinline__ PassWords pass_words(const LookBack& lb, int pass, int radix) {
  uint32_t* block = lb.passes + static_cast<int64_t>(pass) * (2 + 3 * lb.num_groups * radix);
  auto* sums = reinterpret_cast<unsigned long long*>(block + 2);
  return {block, sums, reinterpret_cast<uint32_t*>(sums + lb.num_groups * radix)};
}

// The tile a warp sorts: by look-back the pass's next ticket, else by blockIdx.
template <bool kLookBack>
__device__ __forceinline__ int64_t warp_tile(const PassWords& pw, int lane, int warp) {
  if constexpr (kLookBack) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(pw.ticket, 1u);
    return __shfl_sync(grs::kFullWarp, t, 0);
  } else {
    return static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  }
}

// x summed (or the least of it) over the lanes that hold one digit:
// lanes d, d + radix, d + 2 radix, ... (radix a power of two <= 32).
__device__ __forceinline__ uint32_t digit_sum(uint32_t x, int radix) {
  for (int m = radix; m < 32; m <<= 1) x += __shfl_xor_sync(grs::kFullWarp, x, m);
  return x;
}

__device__ __forceinline__ int digit_min(int x, int radix) {
  for (int m = radix; m < 32; m <<= 1) x = min(x, __shfl_xor_sync(grs::kFullWarp, x, m));
  return x;
}

// The first loads of a tile's look-back: the count words of its group's
// earlier tiles, and of the nearest group row (group g - 1 - lane / radix)
// its prefix and its sum.  They go out as soon as the rank step has
// counted the tile, and the warp reads them after it has staged the tile,
// so that their latency hides behind the staging.
template <int kMaxR>
struct LookAhead {
  uint32_t counts[kMaxR];
  uint32_t prefix;
  unsigned long long sum;
};

// Lane r < radix publishes tile t's count of digit r and adds it to the
// group's sum, then every lane issues the look-back's first loads.
template <int kMaxR>
__device__ __forceinline__ void publish_counts(const LookBack& lb, const PassWords& pw,
                                               int pass, int64_t t, int count, int radix,
                                               int lane, LookAhead<kMaxR>& ahead) {
  const int slots = 32 / radix;
  const int d = lane & (radix - 1);
  const int h = lane / radix;
  const int64_t g = t / kGroup;
  const int q = static_cast<int>(t % kGroup);
  if (lane < radix) {
    grs::store_status(lb.counts + t * radix + lane,
                      static_cast<uint32_t>(pass + 1) << 16 | static_cast<uint32_t>(count));
    atomicAdd(pw.sums + g * radix + lane, 1ull << 32 | static_cast<unsigned long long>(count));
  }
  const uint32_t* crow = lb.counts + (g * kGroup + h) * radix + d;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j)
    if (j < radix && slots * j + h < q) ahead.counts[j] = grs::load_status(crow + 32 * j);
  if (g - 1 - h >= 0) {
    ahead.prefix = grs::load_status(pw.inclusive + (g - 1 - h) * radix + d);
    ahead.sum = grs::load_status(pw.sums + (g - 1 - h) * radix + d);
  }
}

// Lane r < radix brings tile t's count of digit r; returns in lane r the
// offset of the tile's run of digit r: the pass's base of r plus the counts
// of r in tiles 0 to t - 1.  All 32 lanes call it, after publish_counts.
// Lane l reads for digit l % radix the rows (tiles or groups) l / radix,
// l / radix + 32 / radix, ...: each load instruction reads whole rows, and
// each row lies 32 words from the last, so that a load's address is the
// lane's base and a constant.  The tile
//   1. sums the counts of its group's earlier tiles, which took their
//      tickets before it;
//   2. in group g > 0, looks back over groups g - 1, g - 2, ... to the
//      nearest that holds an inclusive prefix, adding the sums of the
//      groups before it whose tiles have all added theirs (before group 0
//      stands the base, an inclusive prefix that is always there); a round
//      reads 32 / radix rows, then twice as many, up to 32, and the first
//      round's loads go out with step 1's; group 0 starts from the base;
//   3. if it is its group's last tile, publishes the group's inclusive
//      prefix.
// A round's rows must all be ready up to its nearest inclusive prefix,
// else the warp reads again those that were not.
template <int kMaxR>
__device__ int look_back(const LookBack& lb, const PassWords& pw, int pass, int64_t t,
                         int count, int radix, int lane, const LookAhead<kMaxR>& ahead) {
  const int slots = 32 / radix;  // rows a load instruction reads
  const int d = lane & (radix - 1);
  const int h = lane / radix;    // the lane's first row
  const int64_t g = t / kGroup;
  const int q = static_cast<int>(t % kGroup);
  const uint32_t own = __shfl_sync(grs::kFullWarp, static_cast<uint32_t>(count), d);
  const uint32_t tagged = static_cast<uint32_t>(pass + 1);
  const uint32_t base = static_cast<uint32_t>(lb.bases[pass * radix + d]);

  uint32_t cnt[kMaxR];  // counts of the group's tiles h, h + slots, ...
  unsigned cmiss = 0;    // bit j: tile row slots j + h (< q), not yet read published
#pragma unroll
  for (int j = 0; j < kMaxR; ++j)
    if (j < radix && slots * j + h < q) cmiss |= 1u << j;
  const uint32_t* crow = lb.counts + (g * kGroup + h) * radix + d;  // row j at + 32 j
  bool counted = q == 0;  // intra is known (alike in every lane)
  uint32_t intra = 0;     // the digit's counts in the group's tiles before t
  bool done = g == 0;     // the digit's prefix at the group's start is known
  uint32_t prefix = done ? base : 0u;
  int loads = 1;          // a lane's group loads this round: slots x loads rows
  bool ahead_read = false;  // the first reads take the words publish_counts loaded
  for (int64_t end = g;;) {  // this round's rows: groups end - 1, end - 2, ...
    uint32_t val[kMaxR];     // group rows end - 1 - h, end - 1 - h - slots, ...
    unsigned miss = 0, incl = 0;
#pragma unroll
    for (int j = 0; j < kMaxR; ++j)
      if (j < loads && !done) miss |= 1u << j;
    const int64_t first = (end - 1 - h) * radix + d;  // row j at - 32 j
    int first_inclusive, first_missing;
    for (;;) {
      if (!counted) {
#pragma unroll
        for (int j = 0; j < kMaxR; ++j) {
          if ((cmiss >> j) & 1u) {
            const uint32_t x = ahead_read ? grs::load_status(crow + 32 * j) : ahead.counts[j];
            if ((x >> 16) == tagged) {
              cnt[j] = x & 0xffffu;
              cmiss &= ~(1u << j);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        if ((miss >> j) & 1u) {
          if (end - 1 - (slots * j + h) < 0) {  // before group 0: the base
            val[j] = base;
            incl |= 1u << j;
            miss &= ~(1u << j);
          } else {
            const bool early = !ahead_read && j == 0;  // the first round's one row a lane
            const uint32_t c =
                early ? ahead.prefix : grs::load_status(pw.inclusive + first - 32 * j);
            const unsigned long long sum =
                early ? ahead.sum : grs::load_status(pw.sums + first - 32 * j);
            if (c & kInclusive) {
              val[j] = c & ~kInclusive;
              incl |= 1u << j;
              miss &= ~(1u << j);
            } else if ((sum >> 32) == kGroup) {
              val[j] = static_cast<uint32_t>(sum);
              miss &= ~(1u << j);
            }
          }
        }
      }
      ahead_read = true;
      if (!counted && __all_sync(grs::kFullWarp, cmiss == 0u)) {
        counted = true;
#pragma unroll
        for (int j = 0; j < kMaxR; ++j)
          if (j < radix && slots * j + h < q) intra += cnt[j];
        intra = digit_sum(intra, radix);
      }
      // Rows slots j + h rise with j: the lane's lowest bit is its nearest row.
      first_inclusive = digit_min(incl ? slots * (__ffs(incl) - 1) + h : 32, radix);
      first_missing = digit_min(miss ? slots * (__ffs(miss) - 1) + h : 32, radix);
      const bool ready = done || first_inclusive < first_missing || first_missing == 32;
      if (counted && __all_sync(grs::kFullWarp, ready)) break;
    }
    uint32_t sum = 0;  // rows up to the nearest inclusive prefix, or the round's all
#pragma unroll
    for (int j = 0; j < kMaxR; ++j)
      if (j < loads && !done && slots * j + h <= first_inclusive) sum += val[j];
    // Every lane shuffles, whether its digit is done or not: digits finish in
    // different rounds, and a shuffle of the full warp needs all 32 lanes.
    prefix += digit_sum(sum, radix);
    done = done || first_inclusive < 32;
    if (__all_sync(grs::kFullWarp, done)) break;
    end -= static_cast<int64_t>(slots) * loads;
    loads = min(2 * loads, radix);
  }
  if (q == kGroup - 1 && lane < radix)
    grs::store_status(pw.inclusive + g * radix + lane, kInclusive | (prefix + intra + own));
  return static_cast<int>(prefix + intra);
}

// Words of shared memory a warp keeps: the staged tile, and off the fast
// route also the rows of run ends and deltas.
__host__ __device__ constexpr int warp_words(int tile, bool fast) {
  return fast ? 2 * kFastTile : 2 * tile + 2 * kMaxRadix;
}

// Steps 2 and 3 of one 1,024-key tile held in k, v: rank (counted(count of
// digit r) in lane r once the tile is counted), then lane r's run offset
// run_offset(count of digit r), then place.  The outputs come in as
// __restrict__ parameters: with this body written into the kernel, where
// they are not, the kernel took 6-9% longer at 2^24 and 100M keys on the
// H100 (PERF.md, Findings).
template <int kBits, typename Counted, typename RunOffset>
__device__ __forceinline__ void rank_and_place(uint32_t (&k)[kItems], uint32_t (&v)[kItems],
                                               Counted counted, RunOffset run_offset,
                                               int shift, int lane, uint32_t* sk, uint32_t* sv,
                                               uint32_t* __restrict__ out_keys,
                                               uint32_t* __restrict__ out_idx, int n) {
  constexpr int kRadix = 1 << kBits;
  const int count = grs::rank_1k<kBits>(k, v, shift, lane, sk, sv, counted);
  const int o = run_offset(count);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = grs::load_generic(sk + 32 * j + lane);
    v[j] = grs::load_generic(sv + 32 * j + lane);
  }
  grs::place_1k<kRadix>(k, v, lane < kRadix ? count : 0, o, lane, out_keys, out_idx, n);
}

// The 1,024-key tile: a warp loads it warp-striped into registers (32 keys
// and 32 indices a lane, all loads issued before the first is used), ranks
// and stages it, finds its run offsets and places it.
template <int kBits, bool kLookBack>
__device__ __forceinline__ void pass_1k(const Buffers& b, const int32_t* __restrict__ offsets,
                                        const int32_t* __restrict__ plan, int pass,
                                        int64_t num_tiles, int shift, int n,
                                        const LookBack& lb) {
  constexpr int kRadix = 1 << kBits;
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const grs::Route route = grs::plan_route(plan, pass);
  if (route.source < 0) return;  // no block barrier follows
  const PassWords pw = kLookBack ? pass_words(lb, pass, kRadix) : PassWords{};
  const int64_t t = warp_tile<kLookBack>(pw, lane, warp);
  if (t >= num_tiles) return;
  const Pair in = buffer(b, route.source), out = buffer(b, route.destination);

  uint32_t* sk = reinterpret_cast<uint32_t*>(smem) +
                 static_cast<size_t>(warp) * warp_words(kFastTile, true);
  uint32_t* sv = sk + kFastTile;
  uint32_t k[kItems], v[kItems];
  int o = 0;
  if constexpr (!kLookBack) o = lane < kRadix ? offsets[t * kRadix + lane] : 0;
  const uint32_t* kin = in.keys + t * kFastTile + lane;
  const uint32_t* vin = in.idx + t * kFastTile + lane;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = grs::load_global(kin + 32 * j);
    v[j] = grs::load_global(vin + 32 * j);
  }
  LookAhead<kRadix> ahead;
  const auto counted = [&](int count) {
    if constexpr (kLookBack) publish_counts(lb, pw, pass, t, count, kRadix, lane, ahead);
  };
  const auto run_offset = [&](int count) {
    if constexpr (kLookBack) {
      return look_back<kRadix>(lb, pw, pass, t, count, kRadix, lane, ahead);
    } else {
      return o;
    }
  };
  rank_and_place<kBits>(k, v, counted, run_offset, shift, lane, sk, sv, out.keys, out.idx, n);
}

// Any other tile: counted from device memory, read again to be staged
// (grs::rank_any) and placed from the staging (grs::place_any).
template <bool kLookBack>
__device__ __forceinline__ void pass_any(const Buffers& b, const int32_t* __restrict__ offsets,
                                         const int32_t* __restrict__ plan, int pass,
                                         int64_t num_tiles, int tile, int shift, int radix,
                                         int bits, int n, const LookBack& lb) {
  extern __shared__ uint4 smem[];  // per warp: the staged tile, then run ends and deltas
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const grs::Route route = grs::plan_route(plan, pass);
  if (route.source < 0) return;  // no block barrier follows
  const PassWords pw = kLookBack ? pass_words(lb, pass, radix) : PassWords{};
  const int64_t t = warp_tile<kLookBack>(pw, lane, warp);
  if (t >= num_tiles) return;

  uint32_t* sk = reinterpret_cast<uint32_t*>(smem) +
                 static_cast<size_t>(warp) * warp_words(tile, false);
  uint32_t* sv = sk + tile;
  int* ends = reinterpret_cast<int*>(sv + tile);
  int* delta = ends + kMaxRadix;
  const int64_t base = t * tile;
  int start;
  const Pair in = buffer(b, route.source), out = buffer(b, route.destination);
  LookAhead<kMaxRadix> ahead;
  const auto counted = [&](int count) {
    if constexpr (kLookBack) publish_counts(lb, pw, pass, t, count, radix, lane, ahead);
  };
  const int count = grs::rank_any(in.keys + base + lane, in.idx + base + lane, tile >> 5, shift,
                                  radix, bits, lane, sk, sv, start, counted);
  int o;
  if constexpr (kLookBack) {
    o = look_back<kMaxRadix>(lb, pw, pass, t, count, radix, lane, ahead);
  } else {
    o = lane < radix ? offsets[t * radix + lane] : 0;
  }
  if (lane < radix) {
    ends[lane] = start + count;
    delta[lane] = grs::run_delta(o, start, tile);
  }
  __syncwarp();
  grs::place_any(sk + lane, sv + lane, tile >> 5, ends, delta, radix, lane, out.keys, out.idx, n);
}

// The kernels of the two routes share one signature; each is pass_1k or
// pass_any of its route.
template <int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    bucketize_scatter_1k_kernel(Buffers b, const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ plan, int pass, int64_t num_tiles,
                                int tile, int shift, int radix, int bits, int n, LookBack lb) {
  pass_1k<kBits, false>(b, offsets, plan, pass, num_tiles, shift, n, lb);
}

// At most kLookBackWarps tiles a block, and three blocks an SM: the
// look-back's loads left ptxas at 254-255 registers, two blocks of 4 warps
// an SM; bounded, it keeps 168 without spilling at radix 16 (bench and
// chip_smoke measure it).
template <int kBits>
__global__ void __launch_bounds__(32 * kLookBackWarps, 3)
    lookback_scatter_1k_kernel(Buffers b, const int32_t* __restrict__ offsets,
                               const int32_t* __restrict__ plan, int pass, int64_t num_tiles,
                               int tile, int shift, int radix, int bits, int n, LookBack lb) {
  pass_1k<kBits, true>(b, offsets, plan, pass, num_tiles, shift, n, lb);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    bucketize_scatter_any_kernel(Buffers b, const int32_t* __restrict__ offsets,
                                 const int32_t* __restrict__ plan, int pass, int64_t num_tiles,
                                 int tile, int shift, int radix, int bits, int n, LookBack lb) {
  pass_any<false>(b, offsets, plan, pass, num_tiles, tile, shift, radix, bits, n, lb);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    lookback_scatter_any_kernel(Buffers b, const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ plan, int pass, int64_t num_tiles,
                                int tile, int shift, int radix, int bits, int n, LookBack lb) {
  pass_any<true>(b, offsets, plan, pass, num_tiles, tile, shift, radix, bits, n, lb);
}

using Kernel = void (*)(Buffers, const int32_t*, const int32_t*, int, int64_t, int, int, int,
                        int, int, LookBack);

template <bool kLookBack>
Kernel kernel_of(bool fast, int bits) {
  if (!fast) return kLookBack ? lookback_scatter_any_kernel : bucketize_scatter_any_kernel;
  switch (bits) {
    case 1: return kLookBack ? lookback_scatter_1k_kernel<1> : bucketize_scatter_1k_kernel<1>;
    case 2: return kLookBack ? lookback_scatter_1k_kernel<2> : bucketize_scatter_1k_kernel<2>;
    case 3: return kLookBack ? lookback_scatter_1k_kernel<3> : bucketize_scatter_1k_kernel<3>;
    default: return kLookBack ? lookback_scatter_1k_kernel<4> : bucketize_scatter_1k_kernel<4>;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Checks the arguments both entry points share, then launches one block per
// threads / 32 tiles of the route's kernel.
template <bool kLookBack>
int launch(const void* keys, const void* idx, const void* offsets, void* out_keys,
           void* out_idx, void* scratch_keys, void* scratch_idx, int64_t num_tiles, int tile,
           int threads, int shift, int radix, const void* plan, int pass, const LookBack& lb,
           void* stream) {
  const bool fast = tile == kFastTile;
  const size_t smem = static_cast<size_t>(threads / 32) * warp_words(tile, fast) *
                      sizeof(uint32_t);
  const void* buffers[] = {keys, idx, out_keys, out_idx, scratch_keys, scratch_idx};
  bool words = true;
  for (const void* p : buffers) words = words && aligned(p, 4);
  if (radix < 2 || radix > kMaxRadix || (radix & (radix - 1)) != 0 || threads < 32 ||
      threads % 32 != 0 || threads > 32 * kMaxWarps || tile <= 0 || tile % 128 != 0 ||
      num_tiles < 0 || (num_tiles > 0 && num_tiles > (INT_MAX - tile) / tile) ||
      smem > kMaxShared || !words ||
      (plan != nullptr && (pass < 0 || scratch_keys == nullptr || scratch_idx == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const Buffers b{{const_cast<uint32_t*>(static_cast<const uint32_t*>(keys)),
                   static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(scratch_keys)},
                  {const_cast<uint32_t*>(static_cast<const uint32_t*>(idx)),
                   static_cast<uint32_t*>(out_idx), static_cast<uint32_t*>(scratch_idx)}};
  const int bits = __builtin_ctz(static_cast<unsigned>(radix));
  const Kernel kernel = kernel_of<kLookBack>(fast, bits);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t per_block = threads / 32;
  kernel<<<static_cast<unsigned>((num_tiles + per_block - 1) / per_block), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(plan), pass,
      num_tiles, tile, shift, radix, bits, static_cast<int>(num_tiles * tile), lb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys, idx: the input, num_tiles * tile uint32 (4-byte aligned); offsets:
// (num_tiles, radix) int32 (global_offsets of the tiles' histograms).
// out_keys, out_idx: the output, or a planned sort's result R;
// scratch_keys, scratch_idx: null, or a planned sort's scratch S; all of
// the input's length, and no two of the buffers overlap.  One warp per tile:
// threads is 32 x the tiles of a block, at most 32 x 8; a warp keeps 8 x
// tile + 128 bytes of shared memory (8 KB on the 1,024-key tile), a block at
// most 232,448.  tile is a multiple of 128, radix a power of two from 2 to
// 16, and num_tiles * tile at most INT_MAX - tile (int32 destinations).
// plan: null, or a fused sort's pass plan on the device, of which entry
// `pass` routes this launch.  Returns cudaGetLastError() after the launch.
extern "C" int grs_bucketize_scatter(const void* keys, const void* idx, const void* offsets,
                                     void* out_keys, void* out_idx, void* scratch_keys,
                                     void* scratch_idx, int64_t num_tiles, int tile, int threads,
                                     int shift, int radix, const void* plan, int pass,
                                     void* stream) {
  if (offsets == nullptr && num_tiles > 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(keys, idx, offsets, out_keys, out_idx, scratch_keys, scratch_idx,
                       num_tiles, tile, threads, shift, radix, plan, pass, LookBack{}, stream);
}

// The same pass with its run offsets by look-back (no offsets table).
// bases: (num_passes, radix) int32, every pass's digit bases over the
// input (key_bits.cu); this launch starts digit r's run at bases[pass, r].
// lookback: 8-byte aligned: num_tiles x radix uint32 count words, then a
// block of 2 + 3 x num_groups x radix uint32 words a pass up to `pass`
// (num_groups = ceil(num_tiles / 32)): its ticket, a spare word, the
// groups' 64-bit sums and 32-bit prefixes.  This pass's block must be zero
// and its count words must hold no tag of this pass (the sort clears it all
// before its first pass), so each pass index serves one launch.  threads
// is at most 32 x kLookBackWarps.  The other arguments are
// grs_bucketize_scatter's.
extern "C" int grs_lookback_scatter(const void* keys, const void* idx, void* out_keys,
                                    void* out_idx, void* scratch_keys, void* scratch_idx,
                                    int64_t num_tiles, int tile, int threads, int shift,
                                    int radix, const void* plan, int pass, const void* bases,
                                    void* lookback, void* stream) {
  if (bases == nullptr || !aligned(bases, 4) || lookback == nullptr || !aligned(lookback, 8) ||
      pass < 0 || threads > 32 * kLookBackWarps || num_tiles < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* counts = static_cast<uint32_t*>(lookback);
  const LookBack lb{static_cast<const int32_t*>(bases), counts, counts + num_tiles * radix,
                    (num_tiles + kGroup - 1) / kGroup};
  return launch<true>(keys, idx, nullptr, out_keys, out_idx, scratch_keys, scratch_idx,
                      num_tiles, tile, threads, shift, radix, plan, pass, lb, stream);
}
