// The fused sort's pass: K1, the offsets scan, K2 and K3 of a pass as one kernel.
//
// Replaces the Pallas kernels that one pass of the JAX package's fused sort
// runs one after the other: gpuradixsort_tpu/kernels/radix.py::_hist_kernel
// and the offsets scan (gpuradixsort_tpu/ops/sort.py:80-87), then
// gpuradixsort_tpu/kernels/bucketize.py::_bucketize_kernel and
// gpuradixsort_tpu/kernels/scatter.py::_window_kernel (:88-92).  The output
// equals scatter_runs(bucketize_tiles(keys, idx, shift), hist, offsets) for
// hist the tiles' digit histograms (K1's) and offsets their global offsets:
// tile t's digit-r run, stably in element order, goes to
// out[offsets[t, r] ...].  A stable partition by digit has one answer, so
// this kernel, which cuts the buffer into partitions and not tiles, gives
// the same output.
//
// Bound on the H100: HBM bytes, 16 a key: key and index each read once and
// written once, plus each partition's status words, written and read once.
// The TPU pair writes the bucketized tiles to HBM and reads them back,
// because the TPU has no random store; K2 and K3 ported that boundary and
// moved 32 bytes a key between them.  Here the bucketized partition stays
// in shared memory.
//
// The kernel (lookback_scatter_kernel, grs_lookback_scatter) reads no
// offsets table (Onesweep, Adinets and Merrill, "Onesweep: A Faster Least
// Significant Digit Radix Sort for GPUs", 2022).
// Its run offsets start from the pass's digit bases, which sort_plan.cu
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
// tickets once, in sort_plan.cu's memset, before its first pass, so a
// graph's replay reads none of the last sort's.
//
// The pass reads the sort's input and writes its result R where the sort's
// argument block (warp.cuh's SortArgs, written before each sort by
// sort_plan.cu's grs_sort_args) says; only the scratch S is a parameter.
// So one graph serves every call of a shape: the caller's keys are read
// where they lie and R is the caller's own.  In every buffer of the sort
// the rows at or past the block's live length are pad rows, (PAD_KEY,
// PAD_INDEX), whatever they hold, and where the block names no index the
// pass makes the input's, element e's index e: the JAX package's jnp.where
// re-padding and jnp.arange index (gpuradixsort_tpu/ops/sort.py:193-194,
// :246-247), with no pass over the buffer.  Pads are PAD_KEY in every
// digit and start at the tail, so a stable pass leaves them where they
// are: a pass walks only the live partitions, those that hold a row below
// the length, reads and places only the live rows, and sort_plan.cu's
// bases count only the live keys.  R's rows from the length on are written once
// a sort, as pads, by the last pass that runs, and only by the blocks whose
// ticket lies past the live partitions (in every other pass they exit at
// once): the first of them writes the straddling partition's tail, and all
// of them fill the rows from the next partition boundary on at write
// bandwidth.  So a partition's block does what it did with every row live.
// The grid covers the live partitions of the host's length (an eager
// launch) or of the padded length (a launch that a graph replays at any
// length), and one block more, up to kFillBlocks more where pads follow.

// Buffers: a launch reads (keys, idx) from buffer `source` and writes buffer
// `destination` of {the input, R, S}.  Without a plan it reads the input
// and writes R.  In a fused sort it follows the sort's pass plan
// (sort_plan.cu): a skipped pass returns at once, and a pass that runs reads
// the input, R or S and writes R or S, never the buffer it reads: one
// partition's stores would land on another partition's keys before that
// partition had read them.  A destination outside [0, n), possible only for
// inconsistent bases, is dropped, as in K3.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kMaxRadix = 16;

// The block and its partition.  Three blocks an SM bound ptxas to 80
// registers (24 bytes spill): on an H100 80GB HBM3 (700 W) that ran faster
// at 2^24 and 100M keys than two blocks at 127 registers, and as fast at
// 1M; four blocks (64 registers) spilled 140-176 bytes and ran slower; 12
// or 8 keys a lane, 384 or 512 threads, and rounds of 4 to 16 loads a lane
// ran slower (PERF.md, Findings).
constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPartItems = 16;                          // keys a lane
constexpr int kPartition = kPartThreads * kPartItems;  // keys a block
constexpr int kPartBlocks = 3;                          // blocks an SM (launch bounds)
constexpr int kLookLoads = 2;                           // status loads a lane a round
constexpr int64_t kFillBlocks = kPartBlocks * 132;     // an eager launch's pad fill: one wave

// A buffer's keys and indices.
struct Pair {
  uint32_t* keys;
  uint32_t* idx;
};

// Buffer i of a sort: the input and the result R from its argument block
// (the block's copy in shared memory), the scratch S from the launch,
// chosen by compares.
__device__ __forceinline__ Pair sort_buffer(const grs::SortArgs& args, Pair scratch, int i) {
  return i == 0 ? Pair{const_cast<uint32_t*>(args.keys), const_cast<uint32_t*>(args.idx)}
                : (i == 1 ? Pair{args.out_keys, args.out_idx} : scratch);
}

// The look-back's words.  bases: every pass's digit bases
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

// Whether no pass after `pass` runs: the pass that writes R's pad rows.
// Without a plan a launch is a pass of its own.
__device__ __forceinline__ bool last_pass(const int32_t* plan, int pass, int num_passes) {
  if (plan == nullptr) return true;
  for (int q = pass + 1; q < num_passes; ++q)
    if (plan[q] >= 0) return false;
  return true;
}

// Rows [start, end) of (keys, idx) set to (PAD_KEY, PAD_INDEX), by thread
// `thread` of `threads`: where both lie alike about 16-byte boundaries, the
// rows before the first one, then 16-byte quads, every threads-th, then
// the rest, every threads-th row.
__device__ void fill_pads(uint32_t* keys, uint32_t* idx, int64_t start, int64_t end,
                          int64_t thread, int64_t threads) {
  const auto k = reinterpret_cast<uintptr_t>(keys + start);
  if (k % 16 == reinterpret_cast<uintptr_t>(idx + start) % 16) {
    const int64_t head = min(static_cast<int64_t>((16 - k % 16) % 16 / 4), end - start);
    if (thread < head) {
      keys[start + thread] = grs::kPadKey;
      idx[start + thread] = grs::kPadIndex;
    }
    start += head;
    const uint4 pad_keys = make_uint4(grs::kPadKey, grs::kPadKey, grs::kPadKey, grs::kPadKey);
    const uint4 pad_idx =
        make_uint4(grs::kPadIndex, grs::kPadIndex, grs::kPadIndex, grs::kPadIndex);
    uint4* kq = reinterpret_cast<uint4*>(keys + start);
    uint4* iq = reinterpret_cast<uint4*>(idx + start);
    const int64_t quads = (end - start) / 4;
    for (int64_t q = thread; q < quads; q += threads) {
      kq[q] = pad_keys;
      iq[q] = pad_idx;
    }
    start += 4 * quads;
  }
  for (int64_t i = start + thread; i < end; i += threads) {
    keys[i] = grs::kPadKey;
    idx[i] = grs::kPadIndex;
  }
}

// One pass over one partition (see the header).
// Rows at or past the live length load as all-ones, so they rank last, in
// the last digit, behind every live key of the partition; that digit's
// published count leaves them out, and the place step stores no slot past
// the live keys.  A block whose ticket lies past the live partitions writes
// R's pad rows in the last pass that runs, and in another exits at once.
template <int kBits>
__global__ void __launch_bounds__(kPartThreads, kPartBlocks)
    lookback_scatter_kernel(const grs::SortArgs* __restrict__ args, Pair scratch,
                            const int32_t* __restrict__ plan, int pass, int num_passes, int n,
                            int shift, LookBack lb) {
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
  const int64_t live_parts = (sort_args.length + kPartition - 1) / kPartition;
  if (part >= live_parts) {  // the whole block, after its one barrier
    if (last_pass(plan, pass, num_passes)) {
      // From the boundary on, 16-byte stores that fill whole sectors.
      const int64_t boundary = min(live_parts * kPartition, static_cast<int64_t>(n));
      if (part == live_parts) {
        fill_pads(sort_args.out_keys, sort_args.out_idx, sort_args.length, boundary,
                  threadIdx.x, kPartThreads);
      }
      fill_pads(sort_args.out_keys, sort_args.out_idx, boundary, n,
                (part - live_parts) * kPartThreads + threadIdx.x,
                (gridDim.x - live_parts) * kPartThreads);
    }
    return;
  }
  const int64_t first = part * kPartition;
  // The partition's live rows, those below the length (at least one): only
  // they are loaded, ranked as keys and placed; in every buffer the rows
  // from the length on are pads.
  const int64_t live_rows = sort_args.length - first;
  const int valid = live_rows < kPartition ? static_cast<int>(live_rows) : kPartition;
  const Pair in = sort_buffer(sort_args, scratch, route.source);
  // Where the block names no index, the input's is made.  One loop each
  // way: a select between the made and the loaded index inside one loop
  // compiled to branches around the loads (91 in the kernel, not 30), and
  // the pass took about 4% longer on the H100 (PERF.md, Findings).

  uint32_t k[kPartItems], v[kPartItems];
  const int e0 = warp * 32 * kPartItems + lane;  // the lane's first element
  if (in.idx == nullptr) {
#pragma unroll
    for (int j = 0; j < kPartItems; ++j) {
      const int e = e0 + 32 * j;
      k[j] = e < valid ? grs::load_global(in.keys + first + e) : grs::kPadKey;
      v[j] = e < valid ? static_cast<uint32_t>(first + e) : grs::kPadIndex;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPartItems; ++j) {
      const int e = e0 + 32 * j;
      k[j] = e < valid ? grs::load_global(in.keys + first + e) : grs::kPadKey;
      v[j] = e < valid ? grs::load_global(in.idx + first + e) : grs::kPadIndex;
    }
  }
  int slot[kPartItems];
  const int count = grs::warp_ranks<kBits>(k, shift, lane, slot);
  if (lane < kRadix) warp_start[warp][lane] = count;
  __syncthreads();

  int start = 0;       // warp 0, lane r: run r's start in the staging
  uint32_t total = 0;  // warp 0, lane r: the partition's live keys of digit r
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

using LookBackKernel = void (*)(const grs::SortArgs*, Pair, const int32_t*, int, int, int, int,
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

}  // namespace

// A fused sort's pass, its run offsets by look-back (no offsets table),
// one block of kPartThreads a partition of kPartition keys.  args: the
// sort's argument block (sort_plan.cu's grs_sort_args, 8-byte aligned): the
// input (buffer 0), its live length and the result R (buffer 1), each n
// uint32; scratch_keys, scratch_idx: null, or the sort's scratch S (buffer
// 2), of the same length; no two of the buffers overlap.  radix: a power of
// two from 2 to 16.  plan: null, or the sort's pass plan on the device
// (sort_plan.cu), of which entry `pass` routes this launch, num_passes its
// entries; without a plan the launch reads the input and writes R.  A
// pass writes its destination's live rows; the last that runs (or an
// unplanned launch) also writes R's rows from the length on as pads.
// n: the padded keys, 0 <= n <= INT_MAX.  rows: the live rows the grid
// covers, length <= rows <= n (the host's length for an eager launch, n
// for one that a graph replays at any length).  bases:
// (num_passes, radix) int32, every pass's digit bases over the live keys
// (sort_plan.cu); this launch starts digit r's run at bases[pass, r].
// lookback: lookback_words uint32, 8-byte aligned: a 64-bit status word a
// (partition, digit), ceil(n / kPartition) x radix of them, then a ticket a
// pass.  This pass's ticket must be zero and the status words must hold no
// tag of this pass (the sort clears them all before its first pass), so
// each pass index serves one launch.  Returns cudaGetLastError() after the
// launch.
extern "C" int grs_lookback_scatter(const void* args, void* scratch_keys, void* scratch_idx,
                                    int64_t n, int64_t rows, int shift, int radix,
                                    const void* plan, int pass, int num_passes, const void* bases,
                                    void* lookback, int64_t lookback_words, void* stream) {
  const int64_t parts = (n + kPartition - 1) / kPartition;
  if (args == nullptr || !aligned(args, 8) || !aligned(scratch_keys, 4) ||
      !aligned(scratch_idx, 4) || !valid_radix(radix) ||
      (plan != nullptr &&
       (scratch_keys == nullptr || scratch_idx == nullptr || pass >= num_passes)) ||
      n < 0 || n > INT_MAX || rows < 0 || rows > n || pass < 0 || bases == nullptr ||
      !aligned(bases, 4) || lookback == nullptr || !aligned(lookback, 8) ||
      lookback_words < 2 * parts * radix + pass + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  // The live partitions of `rows`, then blocks for the pad rows: one more
  // than the partitions past them, up to kFillBlocks.
  const int64_t live_parts = (rows + kPartition - 1) / kPartition;
  const int64_t grid = live_parts + std::min(parts - live_parts + 1, kFillBlocks);
  auto* status = static_cast<unsigned long long*>(lookback);
  const LookBack lb{static_cast<const int32_t*>(bases), status,
                    reinterpret_cast<uint32_t*>(status + parts * radix)};
  const int bits = __builtin_ctz(static_cast<unsigned>(radix));
  lookback_kernel(bits)<<<static_cast<unsigned>(grid), kPartThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const grs::SortArgs*>(args),
      Pair{static_cast<uint32_t*>(scratch_keys), static_cast<uint32_t*>(scratch_idx)},
      static_cast<const int32_t*>(plan), pass, num_passes, static_cast<int>(n), shift, lb);
  return static_cast<int>(cudaGetLastError());
}
