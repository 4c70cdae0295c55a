// The fused sort's pass: bucketize and scatter (K2 then K3) as one kernel.
//
// Replaces the pair of Pallas kernels
// gpuradixsort_tpu/kernels/bucketize.py::_bucketize_kernel and
// gpuradixsort_tpu/kernels/scatter.py::_window_kernel, which one fused pass
// runs one after the other (gpuradixsort_tpu/ops/sort.py:88-92), and on the
// fused sort's main path also the pass's K1 and offsets scan before them
// (:80-87).  The output equals
// scatter_runs(bucketize_tiles(keys, idx, shift), hist, offsets) for hist
// the tiles' digit histograms (K1's): tile t's digit-r run, stably in
// element order, goes to out[offsets[t, r] ...].  A stable partition by
// digit has one answer, so the look-back route, which cuts the buffer into
// partitions and not tiles, gives the same output.
//
// Bound on the H100: HBM bytes, 16 a key: key and index each read once and
// written once, plus each tile's offsets row (the table route) or each
// partition's status words, written and read once (the look-back route).
// The TPU pair writes the bucketized tiles to HBM and reads them back,
// because the TPU has no random store; K2 and K3 ported that boundary and
// moved 32 bytes a key between them.  Here the bucketized tile stays in
// shared memory.
//
// The table route (bucketize_scatter_*_kernel, grs_bucketize_scatter) reads
// its run offsets from K1's histograms through global_offsets, as the JAX
// package's pair does; it runs on no path of the port and stands beside
// the look-back route as its counterpart.  One warp a tile and no block
// barrier, as K2 and K3.  For the default 1,024-key tile
// (bucketize_scatter_1k_kernel) a warp
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
// inconsistent offsets table (or bases), is dropped, as in K3.
//
// The look-back route (lookback_scatter_kernel, grs_lookback_scatter) is
// the fused sort's pass: the JAX package's K1, offsets scan, K2 and K3 of
// one pass in one kernel, no offsets table (Onesweep, Adinets and Merrill,
// "Onesweep: A Faster Least Significant Digit Radix Sort for GPUs", 2022).
// Its run offsets start from the pass's digit bases, which key_bits.cu
// counts in its one read of the sort's input.  A block of kPartThreads
// threads takes a partition of kPartition keys by the pass's ticket (the
// last partition may be ragged and is masked), so it only ever waits on
// partitions whose blocks have started: no deadlock, whatever the order the
// card runs blocks in.  It
//   1. loads the partition warp-striped into registers (kPartItems keys and
//      indices a lane, all loads issued before the first is used);
//   2. ranks each warp's slice by ballots (grs::warp_ranks); warp 0 turns
//      the (warp, digit) counts into each warp's staging bases and the
//      partition's digit counts, which it publishes at once as aggregates;
//   3. stages each warp's slice digit-major in shared memory; warp 0 then
//      looks back over the earlier partitions (Merrill and Garland's
//      decoupled look-back, one level): a round reads kLookLoads x 32 /
//      radix partitions' rows, a ballot per digit finds the nearest
//      inclusive prefix, and the aggregates up to it are summed (before
//      partition 0 stands the pass's base); it then publishes its inclusive
//      prefixes.  No partition waits on another's look-back, only on its
//      predecessors' aggregates, which come right after their rank;
//   4. after one barrier stores the staging run by run: thread i places
//      slots i, i + kPartThreads, ..., each at its run's offset, so a store
//      instruction covers 32 neighbouring slots of one or two runs.
// A status word is 64 bits a (partition, digit), tag high and value low
// (warp.cuh): an inclusive prefix reaches 2^31 - block, so Onesweep's
// 30-bit packing does not fit.  The tag is (pass + 1) << 2 | kind, kind 1
// an aggregate and 2 an inclusive prefix, so that words a skipped or an
// earlier pass left read as not ready; the sort clears the words and the
// tickets once, in key_bits.cu's memset, before its first pass, so a graph's
// replay reads none of the last sort's.
//
// The look-back route reads the sort's input and writes its result R where
// the sort's argument block (warp.cuh's SortArgs, written before each sort
// by key_bits.cu's grs_sort_args) says; only the scratch S is a parameter.
// So one graph serves every call of a shape: the caller's keys are read
// where they lie and R is the caller's own.  Where a pass reads the input,
// its rows at or past the block's live length are pad rows, read as
// PAD_KEY with index PAD_INDEX, and where the block names no index the
// pass makes it, element e's index e: the JAX package's jnp.where
// re-padding and jnp.arange index (gpuradixsort_tpu/ops/sort.py:193-194,
// :246-247), with no pass over the buffer.  Pad rows are real rows,
// counted, ranked and placed; rows past the ragged partition's end are not
// (see lookback_scatter_kernel).

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
constexpr int kMaxShared = 232448;  // shared memory a block may use (H100)

// The look-back route's block and partition.  Three blocks an SM bound
// ptxas to 80 registers (24 bytes spill): on an H100 80GB HBM3 (700 W)
// that ran faster at 2^24 and 100M keys than two blocks at 127 registers,
// and as fast at 1M; four blocks (64 registers) spilled 140-176 bytes and
// ran slower; 12 or 8 keys a lane, 384 or 512 threads, and rounds of 4 to
// 16 loads a lane ran slower (PERF.md, Findings).
constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPartItems = 16;                          // keys a lane
constexpr int kPartition = kPartThreads * kPartItems;  // keys a block
constexpr int kPartBlocks = 3;                          // blocks an SM (launch bounds)
constexpr int kLookLoads = 2;                           // status loads a lane a round

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

// Buffer i of a sort on the look-back route: the input and the result R
// from its argument block (the block's copy in shared memory), the scratch
// S from the launch.
__device__ __forceinline__ Pair sort_buffer(const grs::SortArgs& args, Pair scratch, int i) {
  return i == 0 ? Pair{const_cast<uint32_t*>(args.keys), const_cast<uint32_t*>(args.idx)}
                : (i == 1 ? Pair{args.out_keys, args.out_idx} : scratch);
}

// The look-back route's words.  bases: every pass's digit bases
// (num_passes x radix int32).  status: a 64-bit word a (partition, digit),
// shared by every pass (a tag names its pass); tickets: one a pass, handing
// out its partitions in the order their blocks start.
struct LookBack {
  const int32_t* bases;
  unsigned long long* status;
  uint32_t* tickets;
};

constexpr uint32_t kAggregate = 1, kInclusive = 2;  // the kinds of a status tag

__device__ __forceinline__ uint32_t status_tag(int pass, uint32_t kind) {
  return static_cast<uint32_t>(pass + 1) << 2 | kind;
}

// x summed (or the least of it) over the lanes that hold one digit:
// lanes d, d + radix, d + 2 radix, ... (radix a power of two <= 32).
template <int kRadix>
__device__ __forceinline__ uint32_t digit_sum(uint32_t x) {
#pragma unroll
  for (int m = kRadix; m < 32; m <<= 1) x += __shfl_xor_sync(grs::kFullWarp, x, m);
  return x;
}

template <int kRadix>
__device__ __forceinline__ int digit_min(int x) {
#pragma unroll
  for (int m = kRadix; m < 32; m <<= 1) x = min(x, __shfl_xor_sync(grs::kFullWarp, x, m));
  return x;
}

// Partition `part`'s run offsets: returns in every lane of digit
// d = lane % kRadix the pass's base of d plus the counts of d in partitions
// 0 to part - 1.  One warp, all 32 lanes.  Lane l reads for digit d the
// partitions at distance h, h + slots, ... behind part (h = l / kRadix,
// slots = 32 / kRadix, kLookLoads of them a round), so that a load
// instruction reads whole rows.  A round's rows must be published up to the
// nearest inclusive prefix of each digit, else the warp reads again those
// that were not; a row before partition 0 is the base, an inclusive prefix
// that is always there.
template <int kRadix>
__device__ uint32_t look_back(const LookBack& lb, int pass, int64_t part, int lane) {
  constexpr int kSlots = 32 / kRadix;           // rows a load instruction reads
  constexpr int kWindow = kSlots * kLookLoads;  // rows a round reads
  const int d = lane & (kRadix - 1);
  const int h = lane / kRadix;
  const uint32_t aggregate = status_tag(pass, kAggregate);
  const uint32_t inclusive = status_tag(pass, kInclusive);
  const uint32_t base = static_cast<uint32_t>(lb.bases[pass * kRadix + d]);
  uint32_t prefix = 0;
  bool done = false;  // the digit's prefix is known (alike in its lanes)
  for (int64_t end = part;; end -= kWindow) {  // this round: rows end - 1 - distance
    uint32_t val[kLookLoads];
    unsigned miss = done ? 0u : (1u << kLookLoads) - 1u, incl = 0;
    int first_incl, first_miss;  // the digit's nearest inclusive and unread row, or kWindow
    for (;;) {
#pragma unroll
      for (int j = 0; j < kLookLoads; ++j) {
        if ((miss >> j) & 1u) {
          const int64_t row = end - 1 - h - kSlots * j;
          if (row < 0) {
            val[j] = base;
            incl |= 1u << j;
            miss &= ~(1u << j);
          } else {
            const unsigned long long w = grs::load_status(lb.status + row * kRadix + d);
            const uint32_t tag = static_cast<uint32_t>(w >> 32);
            if (tag == aggregate || tag == inclusive) {
              val[j] = static_cast<uint32_t>(w);
              miss &= ~(1u << j);
              if (tag == inclusive) incl |= 1u << j;
            }
          }
        }
      }
      // Distances h + slots j rise with j: the lane's lowest bit is its nearest row.
      first_incl = digit_min<kRadix>(incl ? h + kSlots * (__ffs(incl) - 1) : kWindow);
      first_miss = digit_min<kRadix>(miss ? h + kSlots * (__ffs(miss) - 1) : kWindow);
      const bool ready = done || first_miss == kWindow || first_incl < first_miss;
      if (__all_sync(grs::kFullWarp, ready)) break;
    }
    uint32_t sum = 0;  // rows up to the nearest inclusive prefix, or the round's all
#pragma unroll
    for (int j = 0; j < kLookLoads; ++j)
      if (!done && h + kSlots * j <= first_incl) sum += val[j];
    // Every lane shuffles, whether its digit is done or not: digits finish
    // in different rounds, and a shuffle of the full warp needs all 32 lanes.
    prefix += digit_sum<kRadix>(sum);
    done = done || first_incl < kWindow;
    if (__all_sync(grs::kFullWarp, done)) break;
  }
  return prefix;
}

// One pass of the look-back route over one partition (see the header).
// Keys past the buffer's end load as all-ones, so they rank last, in the
// last digit, behind every key of the partition; that digit's published
// count leaves them out, and the place step stores no slot past the valid
// keys.  Pad rows of the input, from the live length to n, also load as
// all-ones (PAD_KEY); they come before the rows past the end in element
// order, so they rank before them, and are counted and placed.
template <int kBits>
__global__ void __launch_bounds__(kPartThreads, kPartBlocks)
    lookback_scatter_kernel(const grs::SortArgs* __restrict__ args, Pair scratch,
                            const int32_t* __restrict__ plan, int pass, int n, int shift,
                            LookBack lb) {
  constexpr int kRadix = 1 << kBits;
  constexpr uint32_t kMask = kRadix - 1u;
  __shared__ uint32_t sk[kPartition], sv[kPartition];  // the staged partition
  __shared__ int warp_start[kPartWarps][kRadix];  // each warp's counts, then its staging bases
  __shared__ int delta[kRadix];  // run r's offset in the output less its start in the staging
  __shared__ unsigned ticket;
  // The argument block, read once a block.  Its pointers are read from
  // here where they are used: loaded from device memory by every thread,
  // the compiler re-loads them before each use under the register bound
  // and each element's load waits on one (the pass took 255 us at 2^24
  // keys on the H100, not 132; PERF.md, Findings), where kernel parameters
  // cost no such wait.
  __shared__ grs::SortArgs sort_args;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const grs::Route route = grs::plan_route(plan, pass);
  if (route.source < 0) return;  // the whole block, before any barrier
  if (threadIdx.x == 0) {
    ticket = atomicAdd(lb.tickets + pass, 1u);
    sort_args = *args;
  }
  __syncthreads();
  const int64_t part = ticket;
  const int64_t first = part * kPartition;
  const int valid = n - first < kPartition ? static_cast<int>(n - first) : kPartition;
  const Pair in = sort_buffer(sort_args, scratch, route.source);
  // Rows below `live` are loaded; the input's rows from its length on are
  // pads.  Where the block names no index, the input's is made.  One loop
  // each way: a select between the made and the loaded index inside one
  // loop compiled to branches around the loads (91 in the kernel, not 30),
  // and the pass took about 4% longer on the H100 (PERF.md, Findings).
  const int64_t live_rows = route.source == 0 ? sort_args.length - first : valid;
  const int live = live_rows <= 0 ? 0 : (live_rows < valid ? static_cast<int>(live_rows) : valid);

  uint32_t k[kPartItems], v[kPartItems];
  const int e0 = warp * 32 * kPartItems + lane;  // the lane's first element
  if (in.idx == nullptr) {
#pragma unroll
    for (int j = 0; j < kPartItems; ++j) {
      const int e = e0 + 32 * j;
      k[j] = e < live ? grs::load_global(in.keys + first + e) : grs::kPadKey;
      v[j] = e < live ? static_cast<uint32_t>(first + e) : grs::kPadIndex;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPartItems; ++j) {
      const int e = e0 + 32 * j;
      k[j] = e < live ? grs::load_global(in.keys + first + e) : grs::kPadKey;
      v[j] = e < live ? grs::load_global(in.idx + first + e) : grs::kPadIndex;
    }
  }
  int slot[kPartItems];
  const int count = grs::warp_ranks<kBits>(k, shift, lane, slot);
  if (lane < kRadix) warp_start[warp][lane] = count;
  __syncthreads();

  int start = 0;       // warp 0, lane r: run r's start in the staging
  uint32_t total = 0;  // warp 0, lane r: the partition's valid keys of digit r
  if (warp == 0) {
    int before[kPartWarps];  // lane r: digit r's keys in the warps before w
    int run = 0;
#pragma unroll
    for (int w = 0; w < kPartWarps; ++w) {
      before[w] = run;
      run += lane < kRadix ? warp_start[w][lane] : 0;
    }
    int all;
    start = grs::warp_exclusive_scan(run, lane, all);
    if (lane < kRadix) {
#pragma unroll
      for (int w = 0; w < kPartWarps; ++w) warp_start[w][lane] = start + before[w];
      total = static_cast<uint32_t>(run - (lane == kRadix - 1 ? kPartition - valid : 0));
      grs::store_status(lb.status + part * kRadix + lane,
                        grs::status_word(status_tag(pass, kAggregate), total));
    }
  }
  __syncthreads();

  const int warp_base = lane < kRadix ? warp_start[warp][lane] : 0;
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    const uint32_t d = (k[j] >> shift) & kMask;
    const int pos = __shfl_sync(grs::kFullWarp, warp_base, d) + slot[j];
    sk[pos] = k[j];
    sv[pos] = v[j];
  }
  if (warp == 0) {  // its slice staged, so its registers are free for the look-back
    const uint32_t offset = look_back<kRadix>(lb, pass, part, lane);
    if (lane < kRadix) {
      delta[lane] = static_cast<int>(offset - static_cast<uint32_t>(start));
      grs::store_status(lb.status + part * kRadix + lane,
                        grs::status_word(status_tag(pass, kInclusive), offset + total));
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    const int s = threadIdx.x + kPartThreads * j;
    k[j] = grs::load_generic(sk + s);
    v[j] = grs::load_generic(sv + s);
  }
  const Pair out = sort_buffer(sort_args, scratch, route.destination);
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    const int s = threadIdx.x + kPartThreads * j;
    // Unsigned: the true destination lies in [0, n) exactly when this does.
    const unsigned dst = static_cast<unsigned>(delta[(k[j] >> shift) & kMask]) + s;
    if (s < valid && dst < static_cast<unsigned>(n)) {
      out.keys[dst] = k[j];
      out.idx[dst] = v[j];
    }
  }
}

// Words of shared memory a warp keeps: the staged tile, and off the fast
// route also the rows of run ends and deltas.
__host__ __device__ constexpr int warp_words(int tile, bool fast) {
  return fast ? 2 * kFastTile : 2 * tile + 2 * kMaxRadix;
}

// Steps 2 and 3 of one 1,024-key tile held in k, v: rank, then place at
// lane r's run offset o.  The outputs come in as __restrict__ parameters:
// with this body written into the kernel, where they are not, the kernel
// took 6-9% longer at 2^24 and 100M keys on the H100 (PERF.md, Findings).
template <int kBits>
__device__ __forceinline__ void rank_and_place(uint32_t (&k)[kItems], uint32_t (&v)[kItems],
                                               int o, int shift, int lane, uint32_t* sk,
                                               uint32_t* sv, uint32_t* __restrict__ out_keys,
                                               uint32_t* __restrict__ out_idx, int n) {
  constexpr int kRadix = 1 << kBits;
  const int count = grs::rank_1k<kBits>(k, v, shift, lane, sk, sv);
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
// and stages it, and places it at its offsets row.
template <int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    bucketize_scatter_1k_kernel(Buffers b, const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ plan, int pass, int64_t num_tiles,
                                int tile, int shift, int radix, int bits, int n) {
  constexpr int kRadix = 1 << kBits;
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const grs::Route route = grs::plan_route(plan, pass);
  if (route.source < 0) return;  // no block barrier follows
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;
  const Pair in = buffer(b, route.source), out = buffer(b, route.destination);

  uint32_t* sk = reinterpret_cast<uint32_t*>(smem) +
                 static_cast<size_t>(warp) * warp_words(kFastTile, true);
  uint32_t* sv = sk + kFastTile;
  uint32_t k[kItems], v[kItems];
  const int o = lane < kRadix ? offsets[t * kRadix + lane] : 0;
  const uint32_t* kin = in.keys + t * kFastTile + lane;
  const uint32_t* vin = in.idx + t * kFastTile + lane;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = grs::load_global(kin + 32 * j);
    v[j] = grs::load_global(vin + 32 * j);
  }
  rank_and_place<kBits>(k, v, o, shift, lane, sk, sv, out.keys, out.idx, n);
}

// Any other tile: counted from device memory, read again to be staged
// (grs::rank_any) and placed from the staging (grs::place_any).
__global__ void __launch_bounds__(32 * kMaxWarps)
    bucketize_scatter_any_kernel(Buffers b, const int32_t* __restrict__ offsets,
                                 const int32_t* __restrict__ plan, int pass, int64_t num_tiles,
                                 int tile, int shift, int radix, int bits, int n) {
  extern __shared__ uint4 smem[];  // per warp: the staged tile, then run ends and deltas
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const grs::Route route = grs::plan_route(plan, pass);
  if (route.source < 0) return;  // no block barrier follows
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;

  uint32_t* sk = reinterpret_cast<uint32_t*>(smem) +
                 static_cast<size_t>(warp) * warp_words(tile, false);
  uint32_t* sv = sk + tile;
  int* ends = reinterpret_cast<int*>(sv + tile);
  int* delta = ends + kMaxRadix;
  const int64_t base = t * tile;
  int start;
  const Pair in = buffer(b, route.source), out = buffer(b, route.destination);
  const int count = grs::rank_any(in.keys + base + lane, in.idx + base + lane, tile >> 5, shift,
                                  radix, bits, lane, sk, sv, start);
  const int o = lane < radix ? offsets[t * radix + lane] : 0;
  if (lane < radix) {
    ends[lane] = start + count;
    delta[lane] = grs::run_delta(o, start, tile);
  }
  __syncwarp();
  grs::place_any(sk + lane, sv + lane, tile >> 5, ends, delta, radix, lane, out.keys, out.idx, n);
}

using Kernel = void (*)(Buffers, const int32_t*, const int32_t*, int, int64_t, int, int, int,
                        int, int);

Kernel table_kernel(bool fast, int bits) {
  if (!fast) return bucketize_scatter_any_kernel;
  switch (bits) {
    case 1: return bucketize_scatter_1k_kernel<1>;
    case 2: return bucketize_scatter_1k_kernel<2>;
    case 3: return bucketize_scatter_1k_kernel<3>;
    default: return bucketize_scatter_1k_kernel<4>;
  }
}

using LookBackKernel = void (*)(const grs::SortArgs*, Pair, const int32_t*, int, int, int,
                               LookBack);

LookBackKernel lookback_kernel(int bits) {
  switch (bits) {
    case 1: return lookback_scatter_kernel<1>;
    case 2: return lookback_scatter_kernel<2>;
    case 3: return lookback_scatter_kernel<3>;
    default: return lookback_scatter_kernel<4>;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

bool valid_radix(int radix) {
  return radix >= 2 && radix <= kMaxRadix && (radix & (radix - 1)) == 0;
}

// The table route's checks: radix, the buffers' alignment and a plan's
// scratch.
bool valid_pass(const void* const (&buffers)[6], int radix, const void* plan, int pass) {
  bool words = true;
  for (const void* p : buffers) words = words && aligned(p, 4);
  return valid_radix(radix) && words &&
         (plan == nullptr || (pass >= 0 && buffers[4] != nullptr && buffers[5] != nullptr));
}

Buffers buffers_of(const void* const (&p)[6]) {
  return {{const_cast<uint32_t*>(static_cast<const uint32_t*>(p[0])),
           static_cast<uint32_t*>(const_cast<void*>(p[2])),
           static_cast<uint32_t*>(const_cast<void*>(p[4]))},
          {const_cast<uint32_t*>(static_cast<const uint32_t*>(p[1])),
           static_cast<uint32_t*>(const_cast<void*>(p[3])),
           static_cast<uint32_t*>(const_cast<void*>(p[5]))}};
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
  const void* const buffers[] = {keys, idx, out_keys, out_idx, scratch_keys, scratch_idx};
  const bool fast = tile == kFastTile;
  const size_t smem = static_cast<size_t>(threads / 32) * warp_words(tile, fast) *
                      sizeof(uint32_t);
  if (!valid_pass(buffers, radix, plan, pass) || (offsets == nullptr && num_tiles > 0) ||
      threads < 32 || threads % 32 != 0 || threads > 32 * kMaxWarps || tile <= 0 ||
      tile % 128 != 0 || num_tiles < 0 ||
      (num_tiles > 0 && num_tiles > (INT_MAX - tile) / tile) || smem > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const int bits = __builtin_ctz(static_cast<unsigned>(radix));
  const Kernel kernel = table_kernel(fast, bits);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t per_block = threads / 32;
  kernel<<<static_cast<unsigned>((num_tiles + per_block - 1) / per_block), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      buffers_of(buffers), static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(plan), pass, num_tiles, tile, shift, radix, bits,
      static_cast<int>(num_tiles * tile));
  return static_cast<int>(cudaGetLastError());
}

// The same pass with its run offsets by look-back (no offsets table), one
// block of kPartThreads a partition of kPartition keys.  args: the sort's
// argument block (key_bits.cu's grs_sort_args, 8-byte aligned): the input
// (buffer 0), its live length and the result R (buffer 1), each n uint32;
// scratch_keys, scratch_idx: null, or the sort's scratch S (buffer 2), of
// the same length; no two of the buffers overlap.  radix, plan and pass as
// grs_bucketize_scatter's; without a plan the launch reads the input and
// writes R.  n: the padded keys, 0 <= n <= INT_MAX.  bases: (num_passes,
// radix) int32, every pass's digit bases over the input with its pads
// (key_bits.cu); this launch starts digit r's run at bases[pass, r].
// lookback: lookback_words uint32, 8-byte aligned: a 64-bit status word a
// (partition, digit), ceil(n / kPartition) x radix of them, then a ticket a
// pass.  This pass's ticket must be zero and the status words must hold no
// tag of this pass (the sort clears them all before its first pass), so
// each pass index serves one launch.  Returns cudaGetLastError() after the
// launch.
extern "C" int grs_lookback_scatter(const void* args, void* scratch_keys, void* scratch_idx,
                                    int64_t n, int shift, int radix, const void* plan, int pass,
                                    const void* bases, void* lookback, int64_t lookback_words,
                                    void* stream) {
  const int64_t parts = (n + kPartition - 1) / kPartition;
  if (args == nullptr || !aligned(args, 8) || !aligned(scratch_keys, 4) ||
      !aligned(scratch_idx, 4) || !valid_radix(radix) ||
      (plan != nullptr && (scratch_keys == nullptr || scratch_idx == nullptr)) || n < 0 ||
      n > INT_MAX || pass < 0 || bases == nullptr || !aligned(bases, 4) ||
      lookback == nullptr || !aligned(lookback, 8) ||
      lookback_words < 2 * parts * radix + pass + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto* status = static_cast<unsigned long long*>(lookback);
  const LookBack lb{static_cast<const int32_t*>(bases), status,
                    reinterpret_cast<uint32_t*>(status + parts * radix)};
  const int bits = __builtin_ctz(static_cast<unsigned>(radix));
  lookback_kernel(bits)<<<static_cast<unsigned>(parts), kPartThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const grs::SortArgs*>(args),
      Pair{static_cast<uint32_t*>(scratch_keys), static_cast<uint32_t*>(scratch_idx)},
      static_cast<const int32_t*>(plan), pass, static_cast<int>(n), shift, lb);
  return static_cast<int>(cudaGetLastError());
}
