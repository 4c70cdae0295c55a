// segment_aggregate: a group-by's aggregates over a key-sorted buffer, one
// row a group, compacted to the front, in one kernel.
//
// Replaces the JAX package's aggregate step
// (gpuradixsort_tpu/ops/aggregate.py::aggregate_sorted_flat, :60-119): a
// segmented jax.lax.associative_scan per aggregate (:73-83), whose value at
// each run end is its group's aggregate, then _compact_by_mask (:103;
// gpuradixsort_tpu/ops/filter.py:49-66), which moves the run-end rows to the
// front with the Pallas kernels K1 tile_histograms at radix 2
// (gpuradixsort_tpu/kernels/radix.py:180) and K4 tile_destinations (:223)
// and the XLA scatter after them (gpuradixsort_tpu/ops/permute.py:34).
//
// What it computes.  keys: n uint32, sorted, the live rows (below `live`)
// first.  A run ends where the next key differs or at the buffer's end, and
// counts only if its last row is live: a live key equal to the pad key runs
// on into the pads and its group is dropped.  The live rows are a prefix,
// so a counted run holds only live rows, and the counted runs are groups
// 0..count-1 in key order.  Group g's key and aggregates go to row g of
// each output; every row at or past count is zero.  Aggregates
// (accumulators, AccKind): int32 and uint32 sums wrap modulo 2^32; float32
// sums, and a mean's sum of its values cast to float32, add in float64 and
// round to float32 once; min and max compare int32 signed, uint32 unsigned
// and float32 with NaN propagating (jnp.minimum / jnp.maximum; fminf and
// fmaxf drop it); count is int32; a mean is its rounded sum over the
// float32 count.
//
// Bound on the H100: HBM bytes.  Each key and each distinct input column
// is read once (only the live rows, and the key after the last), and each
// output, the group keys included, is written whole: the memset of the
// entry point zeroes it and the kernel writes the count rows of groups.
//
// Design: one pass, no atomics on values.  A block of kThreads threads
// takes a partition of kPartition rows by ticket (so it waits only on
// partitions whose blocks have started) and
//   1. stages the keys and each distinct column warp by warp in shared
//      memory, with 16-byte loads where the column allows them, a lane
//      issuing all its loads before it stores any (scan.cu's staging);
//   2. reads its kItems consecutive rows a thread: run starts (heads) and
//      counted run ends (tails) as bit masks, each row's key against its
//      neighbour's;
//   3. for each accumulator, reduces its rows in registers from its last
//      head, then scans the warp segmentedly (the reference's Blelloch
//      scan over (value, run start), as Hillis-Steele shuffles whose
//      combine steps, the same for every accumulator, come from one ballot
//      of the heads), and keeps each thread's exclusive value and each
//      warp's total in shared memory.  In a partition of at most
//      kSparseGroups groups (the usual group-by) the same walk keeps each
//      accumulator's value at each run end, at the run's slot (from a
//      block scan of the threads' tail counts): one pass over the rows;
//   4. warp 0 scans the warps' totals the same way (each warp's carry within
//      the partition, and the partition's aggregate), publishes the
//      partition's tail count, whether it holds a head, and each
//      accumulator's value after its last head (a payload, then its 64-bit
//      status word with release semantics), then looks back over the
//      partitions before it (Merrill and Garland's decoupled look-back, as
//      scan.cu): 32 status words a round, the tail counts summed back to
//      the nearest inclusive prefix, the values combined back to the
//      nearest partition that holds a head or an inclusive prefix, so one
//      group over many partitions costs a round, never a walk over rows.
//      It publishes the partition's inclusive prefix (the group base and
//      the value carried out of its last row);
//   5. a sparse partition adds its carry (the partition's, its warp's, its
//      lane's) to each thread's first run end where the run began before
//      the thread, then finishes every output of every group from its
//      accumulators and stores them in order.  A denser one walks its rows
//      again for the group keys and each output, from each thread's carry,
//      stages each run end's value at its slot in shared memory, and the
//      block copies them out in order, so the stores stay coalesced even
//      where every row is its own group.
// Up to kMaxOutputs aggregates and kMaxColumns distinct columns a launch;
// a mean's count and a float32 column's sum share their accumulators with
// count and sum.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Consecutive rows a thread.  32 (partitions of 8,192 rows, 128 registers)
// took 2% less at 100M rows on the H100 and 1.75x as long on unique keys
// (agg_ab.py; PERF.md, Findings).
constexpr int kItems = 16;
constexpr int kSpan = 32 * kItems;             // rows a warp stages
constexpr int kPartition = kThreads * kItems;  // rows a block
constexpr int kMaxColumns = 8;                 // distinct input columns a launch
constexpr int kMaxOutputs = 8;                 // aggregates a launch
constexpr int kMaxAccs = kMaxOutputs + 1;      // eight means' sums and their count
constexpr int kMaxShared = 232448;             // shared memory a block may use (H100)
// The most groups of a sparse partition, whose accumulators' values at its
// run ends (8 bytes each) fit the kPartition words of the output staging.
// Walking the rows once there, not again for each output, took the kernel
// 16-19% less at 1M, 2^24 and 100M rows of about 100 a key on the H100
// (agg_ab.py; PERF.md, Findings).
constexpr int kSparseGroups = kPartition * 4 / (8 * kMaxAccs);
static_assert(kItems <= 32 && 32 % kItems == 0, "a thread's rows in one run of 32 staged words");

// Shared index of element i of a warp's staged span, padded by a word every
// 32, so that the threads' runs of kItems words fall on distinct banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }
constexpr int kSpanWords = padded(kSpan);
constexpr int kStageWords = kWarps * kSpanWords;  // a staged column

// The accumulators (kernels/aggregate.py names the same numbers).
enum AccKind : int {
  kSumU32 = 0,    // int32 or uint32 sum, wrapping
  kSumF32,        // float32 values, summed in float64
  kSumI32AsF32,   // int32 values cast to float32, summed in float64 (a mean)
  kSumU32AsF32,   // uint32 values cast to float32, summed in float64 (a mean)
  kMinI32,
  kMaxI32,
  kMinU32,
  kMaxU32,
  kMinF32,
  kMaxF32,
  kCount,
  kNumKinds
};

bool is_f64_sum(int kind) { return kind >= kSumF32 && kind <= kSumU32AsF32; }

// One launch's columns, accumulators and outputs, by value in the launch's
// parameters.
struct Spec {
  const uint32_t* col[kMaxColumns];
  uint32_t* out[kMaxOutputs];
  int acc_kind[kMaxAccs];
  int acc_col[kMaxAccs];      // the column an accumulator reads; -1 for a count
  int out_acc[kMaxOutputs];   // the accumulator an output finishes
  int out_count[kMaxOutputs]; // a mean's count accumulator, else -1
  int ncol, nacc, nout;
};

// The look-back's words: the ticket, a status word a partition (tag high,
// tail count low), and a payload of nacc 64-bit values a partition for its
// aggregate and for its inclusive prefix.  The entry point clears the ticket
// and the status words before each launch; payloads are written before
// their status word and read only after it.
struct Scratch {
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long* agg;
  unsigned long long* incl;
};

constexpr uint32_t kAggregate = 1, kInclusive = 2, kHead = 4;  // status tag bits
// Status words a lane reads in a look-back round.  Four (128 partitions a
// round) took 2% less at 100M rows on the H100 and 16-17% more at 2^24 on
// equal and on unique keys (agg_ab.py; PERF.md, Findings).
constexpr int kLookLoads = 1;

// An accumulator's value as 64 bits, in shared memory and in the payloads.
__device__ __forceinline__ unsigned long long to_bits(uint32_t x) { return x; }
__device__ __forceinline__ unsigned long long to_bits(int32_t x) {
  return static_cast<uint32_t>(x);
}
__device__ __forceinline__ unsigned long long to_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned long long to_bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b) {
  if constexpr (std::is_same_v<T, double>) {
    return __longlong_as_double(static_cast<long long>(b));
  } else if constexpr (std::is_same_v<T, float>) {
    return __uint_as_float(static_cast<uint32_t>(b));
  } else {
    return static_cast<T>(static_cast<uint32_t>(b));
  }
}

__device__ __forceinline__ uint32_t bits32(uint32_t x) { return x; }
__device__ __forceinline__ uint32_t bits32(int32_t x) { return static_cast<uint32_t>(x); }
__device__ __forceinline__ uint32_t bits32(float x) { return __float_as_uint(x); }

// The accumulators: T, the neutral element, a row's value from its column's
// 32 bits, the combine, and the output's 32 bits.
struct SumU32 {
  using T = uint32_t;
  static __device__ T zero() { return 0u; }
  static __device__ T of(uint32_t b) { return b; }
  static __device__ T op(T a, T b) { return a + b; }
  static __device__ uint32_t out(T s) { return s; }
};

struct Count : SumU32 {
  static __device__ T of(uint32_t) { return 1u; }
};

template <int kFrom>  // the column's type: 0 float32, 1 int32, 2 uint32
struct SumF64 {
  using T = double;
  static __device__ T zero() { return 0.0; }
  static __device__ T of(uint32_t b) {
    const float x = kFrom == 0   ? __uint_as_float(b)
                    : kFrom == 1 ? __int2float_rn(static_cast<int32_t>(b))
                                 : __uint2float_rn(b);
    return static_cast<double>(x);
  }
  static __device__ T op(T a, T b) { return a + b; }
  static __device__ uint32_t out(T s) { return __float_as_uint(__double2float_rn(s)); }
};

template <typename V, bool kMax>
struct Extreme {
  using T = V;
  static __device__ T zero() {
    if constexpr (std::is_same_v<V, float>) {
      return __uint_as_float(kMax ? 0xff800000u : 0x7f800000u);  // -inf, +inf
    } else if constexpr (std::is_same_v<V, int32_t>) {
      return kMax ? INT_MIN : INT_MAX;
    } else {
      return kMax ? 0u : UINT_MAX;
    }
  }
  static __device__ T of(uint32_t b) {
    if constexpr (std::is_same_v<V, float>) {
      return __uint_as_float(b);
    } else {
      return static_cast<V>(b);
    }
  }
  static __device__ T op(T a, T b) {
    if constexpr (std::is_same_v<V, float>) {  // a NaN on either side wins
      return (a != a || (kMax ? a > b : a < b)) ? a : b;
    } else {
      return (kMax ? a > b : a < b) ? a : b;
    }
  }
  static __device__ uint32_t out(T s) { return bits32(s); }
};

// Calls f with the accumulator of `kind` (alike in every thread).
template <class F>
__device__ __forceinline__ void with_acc(int kind, F&& f) {
  switch (kind) {
    case kSumU32: f(SumU32{}); break;
    case kSumF32: f(SumF64<0>{}); break;
    case kSumI32AsF32: f(SumF64<1>{}); break;
    case kSumU32AsF32: f(SumF64<2>{}); break;
    case kMinI32: f(Extreme<int32_t, false>{}); break;
    case kMaxI32: f(Extreme<int32_t, true>{}); break;
    case kMinU32: f(Extreme<uint32_t, false>{}); break;
    case kMaxU32: f(Extreme<uint32_t, true>{}); break;
    case kMinF32: f(Extreme<float, false>{}); break;
    case kMaxF32: f(Extreme<float, true>{}); break;
    default: f(Count{}); break;
  }
}

// A warp's span of kSpan rows from `first` into `span` (padded), rows at or
// past `end` as zeros.  16-byte loads where the span lies whole below `end`
// and the column is 16-byte aligned; every load is issued before the first
// store.
__device__ __forceinline__ void stage_span(const uint32_t* src, int64_t first, int64_t end,
                                           uint32_t* span, int lane) {
  constexpr int kVecs = kItems / 4;
  uint4 q[kVecs];
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0 && first + kSpan <= end) {
    const uint4* v = reinterpret_cast<const uint4*>(src + first);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) q[j] = __ldg(v + 32 * j + lane);
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int64_t g = first + 4 * (32 * j + lane);
      q[j].x = g < end ? __ldg(src + g) : 0u;
      q[j].y = g + 1 < end ? __ldg(src + g + 1) : 0u;
      q[j].z = g + 2 < end ? __ldg(src + g + 2) : 0u;
      q[j].w = g + 3 < end ? __ldg(src + g + 3) : 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int e = 4 * (32 * j + lane);
    span[padded(e)] = q[j].x;
    span[padded(e + 1)] = q[j].y;
    span[padded(e + 2)] = q[j].z;
    span[padded(e + 3)] = q[j].w;
  }
}

// A status word published with release semantics: the payload this thread
// wrote before it is visible to whoever reads the word and then fences.
__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// After reading status words with relaxed loads: the payloads published
// before them become visible to this thread's later loads.
__device__ __forceinline__ void fence_acquire() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// Warp 0 of partition part > 0, after it published its aggregate: the
// groups before the partition (returned in every lane), and in carry[a]
// (lane 0 writes it; it comes in as each accumulator's neutral element)
// each accumulator's value carried into the partition's first row.  A round
// reads kLookLoads x 32 status words, lane l those of partitions
// part - 1 - l - 32 q, and takes them 32 at a time, nearest first.
__device__ uint32_t look_back(const Scratch& sc, const Spec& spec, int64_t part, int lane,
                              unsigned long long* carry) {
  uint32_t prefix = 0;
  bool value_done = false;
  for (int64_t end = part;; end -= 32 * kLookLoads) {
    unsigned long long w[kLookLoads];
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int q = 0; q < kLookLoads; ++q) {
        const int64_t i = end - 1 - lane - 32 * q;
        w[q] = i >= 0 ? grs::load_status(sc.status + i) : grs::status_word(kInclusive, 0u);
        ready = ready && (w[q] >> 32) != 0u;
      }
    } while (!__all_sync(grs::kFullWarp, ready));
    fence_acquire();
#pragma unroll
    for (int q = 0; q < kLookLoads; ++q) {
      const int64_t i = end - 1 - lane - 32 * q;
      const uint32_t tag = static_cast<uint32_t>(w[q] >> 32);
      const unsigned incl = __ballot_sync(grs::kFullWarp, (tag & kInclusive) != 0u);
      const unsigned stop = __ballot_sync(grs::kFullWarp, (tag & (kInclusive | kHead)) != 0u);
      const int count_to = incl ? __ffs(incl) - 1 : 31;
      prefix +=
          __reduce_add_sync(grs::kFullWarp, lane <= count_to ? static_cast<uint32_t>(w[q]) : 0u);
      if (!value_done) {
        // Lanes up to the nearest head or inclusive prefix: the values after
        // its last head (or carried out of it), and every row of the nearer ones.
        const int value_to = stop ? __ffs(stop) - 1 : 31;
        const bool mine = lane <= value_to && i >= 0;
        const unsigned long long* pay =
            ((tag & kInclusive) ? sc.incl : sc.agg) + (i >= 0 ? i : 0) * spec.nacc;
        for (int a = 0; a < spec.nacc; ++a) {
          with_acc(spec.acc_kind[a], [&](auto acc) {
            using A = decltype(acc);
            using T = typename A::T;
            T v = mine ? from_bits<T>(grs::load_status(pay + a)) : A::zero();
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v = A::op(v, __shfl_xor_sync(grs::kFullWarp, v, o));
            if (lane == 0) carry[a] = to_bits(A::op(v, from_bits<T>(carry[a])));
          });
        }
        value_done = stop != 0u;
      }
      if (incl) return prefix;
    }
  }
}

// The combine steps of a segmented Hillis-Steele scan over the lanes of a
// warp, from the lanes whose items hold a head: step i (distance 2^i)
// combines where the lanes it covers hold none.  The same for every
// accumulator.
__device__ __forceinline__ unsigned scan_steps(unsigned head_lanes, int lane) {
  unsigned steps = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int o = 1 << i;
    if (lane >= o && (head_lanes & (((1u << o) - 1u) << (lane - o + 1))) == 0u) steps |= 1u << i;
  }
  return steps;
}

template <class A>
__device__ __forceinline__ typename A::T segmented_scan(typename A::T s, unsigned steps) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const typename A::T p = __shfl_up_sync(grs::kFullWarp, s, 1 << i);
    if ((steps >> i) & 1u) s = A::op(p, s);
  }
  return s;
}

// The value of accumulator `a` carried into this thread's first row: the
// partition's, then its warp's within the partition, then its lane's within
// the warp, each cut at the nearest head before it.
template <class A>
__device__ __forceinline__ typename A::T carry_into(const unsigned long long* carry,
                                                    const unsigned long long* wexcl,
                                                    const unsigned long long* excl, int a,
                                                    int tid, bool warp_head_before,
                                                    bool head_before) {
  using T = typename A::T;
  T s = from_bits<T>(wexcl[a * kWarps + (tid >> 5)]);
  if (!warp_head_before) s = A::op(from_bits<T>(carry[a]), s);
  const T e = from_bits<T>(excl[a * kThreads + tid]);
  return head_before ? e : A::op(s, e);
}

// An output's 32 bits from its accumulator's value s at a run end, and for a
// mean the run's rows cnt: the rounded float64 sum over the float32 count.
template <class A>
__device__ __forceinline__ uint32_t finish(typename A::T s, bool mean, uint32_t cnt) {
  if constexpr (std::is_same_v<typename A::T, double>) {
    if (mean)
      return __float_as_uint(__fdiv_rn(__double2float_rn(s), __uint2float_rn(cnt > 1u ? cnt : 1u)));
  }
  return A::out(s);
}

__global__ void __launch_bounds__(kThreads)
    segment_agg_kernel(const uint32_t* __restrict__ keys, int64_t n,
                       const int32_t* __restrict__ live_ptr, int64_t live_value,
                       const Spec params, uint32_t* keys_out, int32_t* count_out, Scratch sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The launch's spec, copied once a block: indexed by a value known only
  // at run time, a kernel parameter would be copied to each thread's stack.
  __shared__ Spec spec;
  __shared__ unsigned ticket;
  __shared__ int64_t live_rows;
  __shared__ int wtails[kWarps];                    // each warp's counted run ends
  __shared__ bool wflag[kWarps];                    // each warp's rows hold a head
  __shared__ unsigned long long carry[kMaxAccs];    // each accumulator's into the partition
  __shared__ unsigned long long blk[kMaxAccs];      // the partition's aggregate
  __shared__ unsigned warp_heads;                   // bit w: warp w's rows hold a head
  __shared__ uint32_t group_base;                   // groups before the partition

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    spec = params;
    ticket = atomicAdd(sc.ticket, 1u);
    const int64_t l = live_ptr != nullptr ? static_cast<int64_t>(*live_ptr) : live_value;
    live_rows = l < 0 ? 0 : (l > n ? n : l);
  }
  __syncthreads();
  const int64_t part = ticket;
  const int64_t first = part * kPartition;
  const int64_t live = live_rows;
  if (first >= live) return;  // no counted run ends here or later; the whole block
  const int64_t key_end = live < n ? live + 1 : n;  // the live keys and the one after

  uint32_t* kstage = reinterpret_cast<uint32_t*>(smem);
  uint32_t* cstage = kstage + kStageWords;                 // column c at c * kStageWords
  uint32_t* ostage = cstage + spec.ncol * kStageWords;     // kPartition words
  // A sparse partition's accumulators at its run ends: raw[a * kSparseGroups + slot].
  unsigned long long* raw = reinterpret_cast<unsigned long long*>(ostage);
  unsigned long long* excl = reinterpret_cast<unsigned long long*>(ostage + kPartition);
  unsigned long long* wtot = excl + spec.nacc * kThreads;  // [nacc][kWarps]
  unsigned long long* wexcl = wtot + spec.nacc * kWarps;   // [nacc][kWarps]

  // 1. Stage the keys and every column.
  const int64_t span0 = first + static_cast<int64_t>(warp) * kSpan;
  stage_span(keys, span0, key_end, kstage + warp * kSpanWords, lane);
  for (int c = 0; c < spec.ncol; ++c)
    stage_span(spec.col[c], span0, live, cstage + c * kStageWords + warp * kSpanWords, lane);
  __syncthreads();

  // 2. This thread's rows: heads, counted tails.  A thread's kItems rows
  // lie in one run of 32 staged words: words mine .. mine + kItems - 1 of a
  // staged column.
  const int64_t row0 = span0 + lane * kItems;
  const int64_t left = live - row0;
  const int nlive = left <= 0 ? 0 : (left < kItems ? static_cast<int>(left) : kItems);
  const int mine = warp * kSpanWords + padded(lane * kItems);  // the thread's first staged row
  const uint32_t* mykeys = kstage + mine;
  unsigned heads = 0, tails = 0;  // bit j: row j starts a run, ends a counted run
  if (nlive > 0) {
    uint32_t k[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) k[j] = mykeys[j];
    uint32_t prev = 0, next = 0;
    if (row0 > 0) {
      prev = lane > 0    ? kstage[warp * kSpanWords + padded(lane * kItems - 1)]
             : warp > 0 ? kstage[(warp - 1) * kSpanWords + padded(kSpan - 1)]
                        : __ldg(keys + first - 1);
    }
    if (nlive == kItems && row0 + kItems < n) {
      next = lane < 31              ? kstage[warp * kSpanWords + padded(lane * kItems + kItems)]
             : warp < kWarps - 1 ? kstage[(warp + 1) * kSpanWords]
                                 : __ldg(keys + first + kPartition);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j < nlive) {
        const bool head = j == 0 ? row0 == 0 || prev != k[0] : k[j - 1] != k[j];
        const bool tail = row0 + j + 1 >= n || k[j] != (j + 1 < kItems ? k[j + 1] : next);
        heads |= static_cast<unsigned>(head) << j;
        tails |= static_cast<unsigned>(tail) << j;
      }
    }
  }
  const unsigned head_lanes = __ballot_sync(grs::kFullWarp, heads != 0u);
  const bool head_before = (head_lanes & ((1u << lane) - 1u)) != 0u;  // in lanes below
  const unsigned steps = scan_steps(head_lanes, lane);
  int warp_tails;
  const int tails_before = grs::warp_exclusive_scan(__popc(tails), lane, warp_tails);
  if (lane == 0) {
    wtails[warp] = warp_tails;
    wflag[warp] = head_lanes != 0u;
  }
  __syncthreads();
  int slot0 = tails_before;  // the thread's first group's slot in the partition
  int groups = 0;            // the groups ending in the partition
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    slot0 += w < warp ? wtails[w] : 0;
    groups += wtails[w];
  }
  // A partition of few groups (the usual group-by) keeps each accumulator's
  // value at each of its run ends, so that it walks its rows once.
  const bool sparse = groups <= kSparseGroups;  // alike in the block
  // The thread's run end before its first head, if any: its run began
  // before the thread, and its values lack the carry until step 5.
  const unsigned open_first = tails & (heads ? (heads & (0u - heads)) - 1u : ~0u);

  // 3. Each accumulator: the thread's rows from their last head, then the
  // warp's segmented scan; the thread's exclusive value and the warp's total.
  // A sparse partition also keeps the value at each run end.
  for (int a = 0; a < spec.nacc; ++a) {
    const int c = spec.acc_col[a];
    const uint32_t* rows = cstage + (c < 0 ? 0 : c) * kStageWords + mine;
    with_acc(spec.acc_kind[a], [&](auto acc) {
      using A = decltype(acc);
      using T = typename A::T;
      const auto fold = [&](auto keep) {
        T s = A::zero();
        int slot = a * kSparseGroups + slot0;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (j < nlive) {
            const T x = A::of(c < 0 ? 0u : rows[j]);
            s = ((heads >> j) & 1u) ? x : A::op(s, x);
            if constexpr (decltype(keep)::value) {
              if ((tails >> j) & 1u) raw[slot++] = to_bits(s);
            }
          }
        }
        return s;
      };
      T s = sparse ? fold(std::true_type{}) : fold(std::false_type{});
      s = segmented_scan<A>(s, steps);
      const T e = __shfl_up_sync(grs::kFullWarp, s, 1);
      excl[a * kThreads + tid] = to_bits(lane == 0 ? A::zero() : e);
      if (lane == 31) wtot[a * kWarps + warp] = to_bits(s);
    });
  }
  __syncthreads();

  // 4. Each accumulator's warp totals scanned, one accumulator a warp: the
  // warps' carries within the partition and its aggregate.  Then warp 0
  // publishes the aggregate, looks back and publishes the inclusive prefix.
  const unsigned wheads = __ballot_sync(grs::kFullWarp, lane < kWarps && wflag[lane]);
  const unsigned wsteps = scan_steps(wheads, lane);
  for (int a = warp; a < spec.nacc; a += kWarps) {
    with_acc(spec.acc_kind[a], [&](auto acc) {
      using A = decltype(acc);
      using T = typename A::T;
      T s = lane < kWarps ? from_bits<T>(wtot[a * kWarps + lane]) : A::zero();
      s = segmented_scan<A>(s, wsteps);
      const T e = __shfl_up_sync(grs::kFullWarp, s, 1);
      const T total = __shfl_sync(grs::kFullWarp, s, kWarps - 1);
      if (lane < kWarps) wexcl[a * kWarps + lane] = to_bits(lane == 0 ? A::zero() : e);
      if (lane == 0) {
        blk[a] = to_bits(total);
        carry[a] = to_bits(A::zero());
      }
    });
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t base = 0;
    if (part > 0) {
      if (lane == 0) {
        for (int a = 0; a < spec.nacc; ++a) sc.agg[part * spec.nacc + a] = blk[a];
        store_release(sc.status + part,
                      grs::status_word(kAggregate | (wheads ? kHead : 0u),
                                       static_cast<uint32_t>(groups)));
      }
      __syncwarp();
      base = look_back(sc, spec, part, lane, carry);
    }
    if (lane == 0) {
      for (int a = 0; a < spec.nacc; ++a) {
        with_acc(spec.acc_kind[a], [&](auto acc) {
          using A = decltype(acc);
          using T = typename A::T;
          const T b = from_bits<T>(blk[a]);
          sc.incl[part * spec.nacc + a] = to_bits(wheads ? b : A::op(from_bits<T>(carry[a]), b));
        });
      }
      store_release(sc.status + part,
                    grs::status_word(kInclusive, base + static_cast<uint32_t>(groups)));
      group_base = base;
      warp_heads = wheads;
      if (count_out != nullptr && live - 1 < first + kPartition)
        *count_out = static_cast<int32_t>(base + static_cast<uint32_t>(groups));
    }
  }
  __syncthreads();

  // 5. The outputs.
  const int64_t base = group_base;
  const bool warp_head_before = (warp_heads & ((1u << warp) - 1u)) != 0u;
  if (sparse) {
    // Each thread's first run end takes the carry into the thread; then
    // every output of every group, finished from its accumulators, in order.
    if (open_first != 0u) {
      for (int a = 0; a < spec.nacc; ++a) {
        with_acc(spec.acc_kind[a], [&](auto acc) {
          using A = decltype(acc);
          using T = typename A::T;
          unsigned long long& r = raw[a * kSparseGroups + slot0];
          r = to_bits(A::op(carry_into<A>(carry, wexcl, excl, a, tid, warp_head_before,
                                          head_before),
                            from_bits<T>(r)));
        });
      }
    }
    if (keys_out != nullptr) {
      int slot = slot0;
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if ((tails >> j) & 1u) keys_out[base + slot++] = mykeys[j];
    }
    __syncthreads();
    for (int i = tid; i < spec.nout * groups; i += kThreads) {
      const int o = i / groups;
      const int g = i - o * groups;
      const int a = spec.out_acc[o];
      const int cn = spec.out_count[o];
      const uint32_t cnt = cn >= 0 ? static_cast<uint32_t>(raw[cn * kSparseGroups + g]) : 0u;
      with_acc(spec.acc_kind[a], [&](auto acc) {
        using A = decltype(acc);
        spec.out[o][base + g] =
            finish<A>(from_bits<typename A::T>(raw[a * kSparseGroups + g]), cn >= 0, cnt);
      });
    }
    return;
  }
  // A dense partition: for the group keys and each output, every thread
  // walks its rows again from its carry and stages each run end's value at
  // its slot, and the block copies them out in order.
  if (keys_out != nullptr) {
    int slot = slot0;
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if ((tails >> j) & 1u) ostage[slot++] = mykeys[j];
    __syncthreads();
    for (int s = tid; s < groups; s += kThreads) keys_out[base + s] = ostage[s];
    __syncthreads();
  }
  for (int o = 0; o < spec.nout; ++o) {
    const int a = spec.out_acc[o];
    const int cn = spec.out_count[o];
    const int c = spec.acc_col[a];
    const uint32_t* rows = cstage + (c < 0 ? 0 : c) * kStageWords + mine;
    if (tails != 0u) {
      with_acc(spec.acc_kind[a], [&](auto acc) {
        using A = decltype(acc);
        using T = typename A::T;
        T s = carry_into<A>(carry, wexcl, excl, a, tid, warp_head_before, head_before);
        uint32_t cnt = 0;  // a mean's rows in the run so far
        if (cn >= 0)
          cnt = carry_into<SumU32>(carry, wexcl, excl, cn, tid, warp_head_before, head_before);
        int slot = slot0;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (j < nlive) {
            const T x = A::of(c < 0 ? 0u : rows[j]);
            const bool head = (heads >> j) & 1u;
            s = head ? x : A::op(s, x);
            cnt = head ? 1u : cnt + 1u;
            if ((tails >> j) & 1u) ostage[slot++] = finish<A>(s, cn >= 0, cnt);
          }
        }
      });
    }
    __syncthreads();
    uint32_t* out = spec.out[o];
    for (int s = tid; s < groups; s += kThreads) out[base + s] = ostage[s];
    __syncthreads();
  }
}

size_t shared_bytes(int ncol, int nacc) {
  return sizeof(uint32_t) * (static_cast<size_t>(1 + ncol) * kStageWords + kPartition) +
         sizeof(unsigned long long) * static_cast<size_t>(nacc) * (kThreads + 2 * kWarps);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// keys: n uint32 (4-byte aligned), sorted, the live rows first; 0 <= n <=
// INT_MAX.  live_ptr: null, or an int32 on the card holding the live rows;
// else live_value holds them (either is clamped to [0, n]).  spec: num_words
// int64 words, read here before the launch: ncol, nacc, nout; ncol column
// addresses (n rows of 4 bytes each, 4-byte aligned); nacc (kind, column)
// pairs (AccKind; column -1 for kCount, else below ncol); nout (address,
// accumulator, count accumulator) triples (an output of n 4-byte rows; the
// count accumulator -1, or a kCount one beside a float64 sum, for a mean).
// ncol <= 8, nacc <= 9, nout <= 8.  keys_out: null, or the group keys (n
// uint32); count_out: null, or the group count (one int32).  Every output
// is zeroed here on the stream, then the kernel writes the groups' rows.
// scratch: scratch_words int64 words, 8-byte aligned, at least 1 + parts *
// (1 + 2 nacc) for parts = ceil(n / 4096); its first 1 + parts are
// cleared here.  Returns the first error of the memsets and the launch, or
// cudaGetLastError() after it.
extern "C" int grs_segment_aggregate(const void* keys, int64_t n, const void* live_ptr,
                                     int64_t live_value, const int64_t* spec_words,
                                     int num_words, void* keys_out, void* count_out,
                                     void* scratch, int64_t scratch_words, void* stream) {
  if (keys == nullptr || !aligned(keys, 4) || n < 0 || n > INT_MAX || spec_words == nullptr ||
      num_words < 3 || scratch == nullptr || !aligned(scratch, 8) ||
      (live_ptr != nullptr && !aligned(live_ptr, 4)) ||
      (keys_out != nullptr && !aligned(keys_out, 4)) ||
      (count_out != nullptr && !aligned(count_out, 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spec spec{};
  spec.ncol = static_cast<int>(spec_words[0]);
  spec.nacc = static_cast<int>(spec_words[1]);
  spec.nout = static_cast<int>(spec_words[2]);
  if (spec.ncol < 0 || spec.ncol > kMaxColumns || spec.nacc < 0 || spec.nacc > kMaxAccs ||
      spec.nout < 0 || spec.nout > kMaxOutputs ||
      num_words != 3 + spec.ncol + 2 * spec.nacc + 3 * spec.nout) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* w = spec_words + 3;
  for (int c = 0; c < spec.ncol; ++c, ++w) {
    spec.col[c] = reinterpret_cast<const uint32_t*>(*w);
    if (spec.col[c] == nullptr || !aligned(spec.col[c], 4))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int a = 0; a < spec.nacc; ++a, w += 2) {
    spec.acc_kind[a] = static_cast<int>(w[0]);
    spec.acc_col[a] = static_cast<int>(w[1]);
    const bool count = spec.acc_kind[a] == kCount;
    if (w[0] < 0 || w[0] >= kNumKinds || (count ? w[1] != -1 : (w[1] < 0 || w[1] >= spec.ncol)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int o = 0; o < spec.nout; ++o, w += 3) {
    spec.out[o] = reinterpret_cast<uint32_t*>(w[0]);
    spec.out_acc[o] = static_cast<int>(w[1]);
    spec.out_count[o] = static_cast<int>(w[2]);
    if (spec.out[o] == nullptr || !aligned(spec.out[o], 4) || w[1] < 0 || w[1] >= spec.nacc ||
        (w[2] != -1 && (w[2] < 0 || w[2] >= spec.nacc || spec.acc_kind[w[2]] != kCount ||
                        !is_f64_sum(spec.acc_kind[w[1]])))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int64_t parts = (n + kPartition - 1) / kPartition;
  if (scratch_words < 1 + parts * (1 + 2 * static_cast<int64_t>(spec.nacc)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(spec.ncol, spec.nacc);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);

  const auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t err = cudaSuccess;
  for (int o = 0; o < spec.nout && err == cudaSuccess; ++o)
    err = cudaMemsetAsync(spec.out[o], 0, bytes, s);
  if (err == cudaSuccess && keys_out != nullptr) err = cudaMemsetAsync(keys_out, 0, bytes, s);
  if (err == cudaSuccess && count_out != nullptr)
    err = cudaMemsetAsync(count_out, 0, sizeof(int32_t), s);
  if (err == cudaSuccess && parts > 0)
    err = cudaMemsetAsync(scratch, 0, (1 + parts) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (parts == 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(segment_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto* words = static_cast<unsigned long long*>(scratch);
  const Scratch sc{reinterpret_cast<unsigned*>(words), words + 1, words + 1 + parts,
                   words + 1 + parts + parts * spec.nacc};
  segment_agg_kernel<<<static_cast<unsigned>(parts), kThreads, smem, s>>>(
      static_cast<const uint32_t*>(keys), n, static_cast<const int32_t*>(live_ptr), live_value,
      spec, static_cast<uint32_t*>(keys_out), static_cast<int32_t*>(count_out), sc);
  return static_cast<int>(cudaGetLastError());
}
