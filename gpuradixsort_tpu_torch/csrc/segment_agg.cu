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
// and the XLA scatter after them (gpuradixsort_tpu/ops/permute.py:34).  With
// `rows` it also takes the gather before the step
// (gpuradixsort_tpu/ops/aggregate.py:142-147, sort_table's take).
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
// float32 count.  Without `rows` a column's row i is its element i; with
// `rows` (the sort's permutation, n int32) it is its element rows[i],
// clamped to the column's rows as ops/permute.py::gather_rows clamps it
// (a pad row's -1 to row 0).  Neither rows[i] nor a column is read at a
// row that is not live.
//
// Bound on the H100: HBM bytes.  Each key, each distinct column and `rows`
// are read once (only the live rows, and the key after the last), and each
// output, the group keys included, is written whole: the memsets of the
// entry point zero it and the kernel writes the count rows of groups.
// Through `rows` a column's reads land at random: a 32-byte sector a row,
// 8x its 4 bytes (0.96 ms for one column of 100M rows at 3.35 TB/s), and
// the rate of such reads, not their bytes, bounds that route (below).
//
// Design: one pass, no atomics on values.  A block of kWalkWarps walking
// warps and one look-back warp takes a partition of kPartition rows by
// ticket (so it waits only on partitions whose blocks have started).  The
// first design's block spent 35k SM cycles at 100M rows, 9.6k of them in a
// look-back that began only after its walks, while its other warps waited
// at a barrier, and that waited on partitions whose aggregates came after
// their walks too (PERF.md, Findings).  Here:
//   1. the walking warps stage the keys and each distinct column, a warp its
//      span, in shared memory.  A lane issues all its loads before it stores
//      any (coherent loads, which ptxas keeps in place): its 16 keys and 16
//      row indices, then, for each column, the 16 values at those indices,
//      so a warp keeps 512 random reads in flight;
//   2. they mark run starts (heads) and counted run ends (tails) in their
//      kItems consecutive rows a thread, and each warp's last head;
//   3. they fold each accumulator over the partition's last run only, from
//      its last head (all its rows where it holds none): with its tail count
//      and whether it holds a head this is the partition's aggregate, which
//      the look-back warp publishes at once.  Every partition's aggregate
//      thus appears a few thousand cycles after it starts, and a look-back
//      never waits on another block's walks;
//   4. the look-back warp looks back over the partitions before it
//      (Merrill and Garland's decoupled look-back, as scan.cu): 32 status
//      words a round, the tail counts summed back to the nearest inclusive
//      prefix, the values combined back to the nearest partition that holds a
//      head or an inclusive prefix, so one group over many partitions costs a
//      round, never a walk over rows.  It publishes the partition's inclusive
//      prefix (the group base and the value carried out of its last row),
//      and meets the walking warps at a named barrier.  Meanwhile, off its
//      path:
//   5. the walking warps walk each accumulator over their rows from shared
//      memory, branch-free (a row past the live ones holds no head and no
//      tail, and is folded unchecked after the thread's last run end): each
//      from its last head, then a segmented scan over the warp
//      (Hillis-Steele shuffles whose combine steps, the same for every
//      accumulator, come from one ballot of the heads), each thread's
//      exclusive value and each warp's total kept in shared memory, and in a
//      partition of at most kSparseGroups groups (the usual group-by) each
//      accumulator's value at each run end, at the run's slot (from a scan
//      of the tail counts), so the rows are walked once; then they scan the
//      warps' totals (one accumulator a warp);
//   6. they meet the look-back warp at the named barrier; a sparse partition
//      adds its carry (the partition's, its warp's, its lane's) to each
//      thread's first run end where the run began before the thread, then
//      finishes every output of every group from its accumulators and
//      stores them in order.  A denser one walks its rows again for the
//      group keys and each output, from each thread's carry, stages each run
//      end's value at its slot in shared memory, and the whole block, the
//      look-back warp too, copies them out in order, so the stores stay
//      coalesced even where every row is its own group.  A partition with no
//      run end stores nothing: its walking warps leave after step 3.
// Through `rows` the kernel is bound by the random reads' rate, not by its
// bytes: at 100M rows of one column it reads about 26 G rows/s on the H100,
// near the 29 G rows/s of index_select's gather in the group-by it replaces
// (agg_ab.py, chip_smoke.py; PERF.md, Findings).
// Up to kMaxOutputs aggregates and kMaxColumns distinct columns a launch;
// a mean's count and a float32 column's sum share their accumulators with
// count and sum.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "warp.cuh"

// A traced build (agg_ab.py compiles this file with -DGRS_TRACE) keeps the
// SM clock at each step of each block, for partitions below
// GRS_TRACE_PARTS; grs_segment_aggregate_trace copies the clocks out and
// clears them.  Other builds compile the marks to nothing.
#ifdef GRS_TRACE
#define GRS_TRACE_PARTS (1 << 15)
#define GRS_TRACE_STEPS 10
__device__ long long grs_trace[GRS_TRACE_PARTS][GRS_TRACE_STEPS];
#define GRS_MARK_AT(i, who, t)                                                \
  do {                                                                        \
    if ((who) && part < GRS_TRACE_PARTS) grs_trace[part][i] = (t);            \
  } while (0)
#else
#define GRS_MARK_AT(i, who, t) \
  do {                         \
  } while (0)
#endif
#define GRS_MARK(i, who) GRS_MARK_AT(i, who, clock64())

namespace {

constexpr int kWalkWarps = 8;                   // warps that stage and walk the rows
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kThreads = kWalkThreads + 32;      // and one warp that looks back:
constexpr int kLookWarp = 0;  // the block's first (its last measured the same; PERF.md)
// Three blocks an SM: at most 72 registers a thread (with a little spill).
// Seven walking warps (256 threads, 80 registers) took 9% longer at 100M rows
// on the H100 (agg_ab.py; PERF.md, Findings).
constexpr int kBlocksPerSm = 3;
// Consecutive rows a thread.  32 (128 registers, in the first design) took
// 2% less at 100M rows on the H100 and 1.75x as long on unique keys
// (agg_ab.py; PERF.md, Findings).
constexpr int kItems = 16;
constexpr int kSpan = 32 * kItems;                 // rows a warp stages
constexpr int kPartition = kWalkWarps * kSpan;     // rows a block
constexpr int kMaxColumns = 8;                     // distinct input columns a launch
constexpr int kMaxOutputs = 8;                     // aggregates a launch
constexpr int kMaxAccs = kMaxOutputs + 1;          // eight means' sums and their count
constexpr int kMaxShared = 232448;                 // shared memory a block may use (H100)
// The most groups of a sparse partition, whose accumulators' values at its
// run ends (8 bytes each) fit the kPartition words of the output staging.
// Walking the rows once there, not again for each output, took the kernel
// 16-19% less at 1M, 2^24 and 100M rows of about 100 a key on the H100
// (agg_ab.py; PERF.md, Findings).
constexpr int kSparseGroups = kPartition * 4 / (8 * kMaxAccs);
static_assert(kItems <= 32 && 32 % kItems == 0, "a thread's rows in one run of 32 staged words");
static_assert(kItems % 4 == 0, "a lane stages its rows 4 at a time");

// Named barriers (0 is __syncthreads): the walking warps alone, and the
// walking warps with the look-back warp once it has published the carry.
constexpr int kBarWalk = 1, kBarJoin = 2;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Shared index of element i of a warp's staged span, padded by a word every
// 32, so that the threads' runs of kItems words fall on distinct banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }
constexpr int kSpanWords = padded(kSpan);
constexpr int kStageWords = kWalkWarps * kSpanWords;  // a staged column

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
  int64_t col_rows[kMaxColumns];  // a column's rows (those `rows` may index)
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
// equal and on unique keys in the first design (agg_ab.py; PERF.md, Findings).
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

// Calls f(a, acc, x) for each accumulator a, x[j] the thread's staged row j
// of its column in shared memory (a count's: any column's, unread).  Each
// accumulator reads its rows itself: loading a column's rows once into
// registers for all of its accumulators spilled and took 23% longer at
// 100M rows on the H100 (agg_ab.py; PERF.md, Findings).
template <class F>
__device__ __forceinline__ void each_acc(const Spec& spec, const uint32_t* cstage, int mine,
                                         F&& f) {
  for (int a = 0; a < spec.nacc; ++a) {
    const int c = spec.acc_col[a];
    const uint32_t* x = cstage + (c < 0 ? 0 : c) * kStageWords + mine;
    with_acc(spec.acc_kind[a], [&](auto acc) { f(a, acc, x); });
  }
}

// Coherent global loads, issued where they stand: ptxas sinks an
// ld.global.nc (or __ldg) down to its one use, here a store to shared
// memory, and a lane's loads would then stop overlapping (csrc/tile.cuh).
__device__ __forceinline__ uint4 load_v4(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t load_u32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A value read at a random row: cached in L2 only, where its 32-byte sector
// lands; an L1 line would hold neighbours no other lane asks for.
__device__ __forceinline__ uint32_t load_cg(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The element of a warp's span that a lane holds as its word i: 4 (32 (i /
// 4) + lane) + i % 4, so the warp's 16-byte loads of one i / 4 cover 512
// contiguous bytes.
__device__ __forceinline__ int span_elem(int i, int lane) {
  return 4 * (32 * (i / 4) + lane) + i % 4;
}

// A warp's span of kSpan words from `first` into registers (v[i] is word
// span_elem(i, lane)); words at or past `end` are zeros and are not read.
// 16-byte loads where the span lies whole below `end` and `src` is 16-byte
// aligned.
__device__ __forceinline__ void load_span(const uint32_t* src, int64_t first, int64_t end,
                                          uint32_t (&v)[kItems], int lane) {
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0 && first + kSpan <= end) {
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const uint4 q = load_v4(src + first + 4 * (32 * j + lane));
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t g = first + span_elem(i, lane);
      v[i] = g < end ? load_u32(src + g) : 0u;
    }
  }
}

__device__ __forceinline__ void store_span(const uint32_t (&v)[kItems], uint32_t* span,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) span[padded(span_elem(i, lane))] = v[i];
}

// A column's values at a span's row indices r (as load_span lays them out),
// each clamped to [0, rows), into `span` (padded), all of a lane's loads
// issued before the first is stored (8 at a time measured no faster);
// words at or past `end` are zeros and are not read.
__device__ __forceinline__ void gather_span(const uint32_t* col, int64_t rows,
                                            const uint32_t (&r)[kItems], int64_t first,
                                            int64_t end, uint32_t* span, int lane) {
  const int64_t top = rows - 1;
  const auto at = [&](uint32_t ri) {
    const int64_t i = static_cast<int32_t>(ri);
    return col + (i < 0 ? 0 : (i > top ? top : i));
  };
  const bool whole = first + kSpan <= end;
  uint32_t v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    v[i] = whole || first + span_elem(i, lane) < end ? load_cg(at(r[i])) : 0u;
  store_span(v, span, lane);
}

// A status word published with release semantics: the payload this thread
// wrote before it is visible to whoever reads the word and then fences.
__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// After reading status words with relaxed loads: the payloads published
// before them become visible to this thread's later loads.
__device__ __forceinline__ void fence_acquire() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// The look-back warp of partition part > 0, after it published its
// aggregate: the groups before the partition (returned in every lane), and
// in carry[a] (lane 0 writes it; it comes in as each accumulator's neutral
// element) each accumulator's value carried into the partition's first row.
// A round reads kLookLoads x 32 status words, lane l those of partitions
// part - 1 - l - 32 q, and takes them 32 at a time, nearest first.  Rounds
// after the values are done read no payload, so they need no fence.
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
    if (!value_done) fence_acquire();
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
  T s = from_bits<T>(wexcl[a * kWalkWarps + (tid >> 5)]);
  if (!warp_head_before) s = A::op(from_bits<T>(carry[a]), s);
  const T e = from_bits<T>(excl[a * kWalkThreads + tid]);
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

// Step 5 of a walking warp: each accumulator's walk over the thread's rows
// from their last head, then the warp's segmented scan; the thread's
// exclusive value and the warp's total.  A sparse partition also keeps the
// value at each run end.  Then the walking warps' barrier, and each
// accumulator's warp totals scanned, one accumulator a warp: the warps'
// carries within the partition.
__device__ __forceinline__ void walk(const Spec& spec, const uint32_t* cstage, int mine,
                                     unsigned heads, unsigned tails,
                                     unsigned head_lanes, unsigned wheads, int slot0, int groups,
                                     int lane, int ww, int wt, unsigned long long* raw,
                                     unsigned long long* excl, unsigned long long* wtot,
                                     unsigned long long* wexcl) {
  const unsigned steps = scan_steps(head_lanes, lane);
  // A partition of few groups (the usual group-by) keeps each accumulator's
  // value at each of its run ends, so that it walks its rows once.
  const bool sparse = groups <= kSparseGroups;  // alike in the block
  each_acc(spec, cstage, mine, [&](int a, auto acc, const auto& x) {
    using A = decltype(acc);
    using T = typename A::T;
    // Rows past the live ones (staged as zeros) hold no head and no tail:
    // they are folded into the thread's value unchecked, after its last run
    // end, where no output and no carry reads it.  A check a row would
    // branch, and each row's load would wait for the one before.
    const auto fold = [&](auto keep) {
      T s = A::zero();
      int slot = a * kSparseGroups + slot0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const T v = A::of(x[j]);
        s = ((heads >> j) & 1u) ? v : A::op(s, v);
        if constexpr (decltype(keep)::value) {
          if ((tails >> j) & 1u) raw[slot++] = to_bits(s);
        }
      }
      return s;
    };
    T s = sparse ? fold(std::true_type{}) : fold(std::false_type{});
    s = segmented_scan<A>(s, steps);
    const T e = __shfl_up_sync(grs::kFullWarp, s, 1);
    excl[a * kWalkThreads + wt] = to_bits(lane == 0 ? A::zero() : e);
    if (lane == 31) wtot[a * kWalkWarps + ww] = to_bits(s);
  });
  bar_sync(kBarWalk, kWalkThreads);
  const unsigned wsteps = scan_steps(wheads, lane);
  for (int a = ww; a < spec.nacc; a += kWalkWarps) {
    with_acc(spec.acc_kind[a], [&](auto acc) {
      using A = decltype(acc);
      using T = typename A::T;
      T s = lane < kWalkWarps ? from_bits<T>(wtot[a * kWalkWarps + lane]) : A::zero();
      s = segmented_scan<A>(s, wsteps);
      const T e = __shfl_up_sync(grs::kFullWarp, s, 1);
      if (lane < kWalkWarps) wexcl[a * kWalkWarps + lane] = to_bits(lane == 0 ? A::zero() : e);
    });
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    segment_agg_kernel(const uint32_t* __restrict__ keys, int64_t n,
                       const int32_t* __restrict__ live_ptr, int64_t live_value,
                       const uint32_t* __restrict__ rows, const Spec params,
                       uint32_t* keys_out, int32_t* count_out, Scratch sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The launch's spec, copied once a block: indexed by a value known only
  // at run time, a kernel parameter would be copied to each thread's stack.
  __shared__ Spec spec;
  __shared__ unsigned ticket;
  __shared__ int64_t live_rows;
  __shared__ int wtails[kWalkWarps];                // each warp's counted run ends
  __shared__ int wlast[kWalkWarps];                 // 1 + each warp's last head's row, or 0
  __shared__ unsigned long long carry[kMaxAccs];    // each accumulator's into the partition
  __shared__ unsigned long long blk[kMaxAccs];      // the partition's aggregate
  __shared__ uint32_t group_base;                   // groups before the partition
  __shared__ uint32_t edge[2];                      // the keys before and after the partition
#ifdef GRS_TRACE
  const long long start = clock64();
#endif

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool walker = warp != kLookWarp;
  // A walking warp's index among the walking warps, and its thread's.
  const int ww = warp - (warp > kLookWarp ? 1 : 0);
  const int wt = 32 * ww + lane;
  if (tid == 0) {
    spec = params;
    ticket = atomicAdd(sc.ticket, 1u);
    const int64_t l = live_ptr != nullptr ? static_cast<int64_t>(*live_ptr) : live_value;
    live_rows = l < 0 ? 0 : (l > n ? n : l);
  }
  __syncthreads();
  const int64_t part = ticket;
  GRS_MARK_AT(0, tid == 0, start);
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
  unsigned long long* wtot = excl + spec.nacc * kWalkThreads;  // [nacc][kWalkWarps]
  unsigned long long* wexcl = wtot + spec.nacc * kWalkWarps;   // [nacc][kWalkWarps]
  unsigned long long* wagg = wexcl + spec.nacc * kWalkWarps;   // [nacc][kWalkWarps]

  // 1. Stage the keys and every column: a lane's key and index loads, then
  // (the keys stored meanwhile) each column's value loads, then its stores.
  const int64_t span0 = first + static_cast<int64_t>(ww) * kSpan;
  if (walker) {
    uint32_t x[kItems], r[kItems];  // r: the row indices, or a column read directly
    load_span(keys, span0, key_end, x, lane);
    uint32_t before = 0, after = 0;  // the keys either side, for the first and last thread
    if (wt == 0 && first > 0) before = load_u32(keys + first - 1);
    if (wt == kWalkThreads - 1 && first + kPartition < n) after = load_u32(keys + first + kPartition);
    if (rows != nullptr) {
      load_span(rows, span0, live, r, lane);
    } else if (spec.ncol > 0) {
      load_span(spec.col[0], span0, live, r, lane);
    }
    store_span(x, kstage + ww * kSpanWords, lane);
    for (int c = 0; c < spec.ncol; ++c) {
      uint32_t* span = cstage + c * kStageWords + ww * kSpanWords;
      if (rows != nullptr) {
        gather_span(spec.col[c], spec.col_rows[c], r, span0, live, span, lane);
      } else {
        if (c > 0) load_span(spec.col[c], span0, live, r, lane);
        store_span(r, span, lane);
      }
    }
    if (wt == 0) edge[0] = before;
    if (wt == kWalkThreads - 1) edge[1] = after;
  }
  __syncthreads();
  GRS_MARK(1, walker && wt == 0);

  // 2. This thread's rows: heads, counted tails.  A thread's kItems rows
  // lie in one run of 32 staged words: words mine .. mine + kItems - 1 of a
  // staged column.
  const int prow = ww * kSpan + lane * kItems;  // the thread's first row in the partition
  const int64_t row0 = first + prow;
  const int64_t left = live - row0;
  const int nlive = !walker || left <= 0 ? 0 : (left < kItems ? static_cast<int>(left) : kItems);
  const int mine = ww * kSpanWords + padded(lane * kItems);  // the thread's first staged row
  const uint32_t* mykeys = kstage + mine;
  unsigned heads = 0, tails = 0;  // bit j: row j starts a run, ends a counted run
  if (nlive > 0) {
    uint32_t k[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) k[j] = mykeys[j];
    uint32_t prev = 0, next = 0;
    if (row0 > 0) {
      prev = lane > 0 ? kstage[ww * kSpanWords + padded(lane * kItems - 1)]
             : ww > 0 ? kstage[(ww - 1) * kSpanWords + padded(kSpan - 1)]
                      : edge[0];
    }
    if (nlive == kItems && row0 + kItems < n) {
      next = lane < 31             ? kstage[ww * kSpanWords + padded(lane * kItems + kItems)]
             : ww < kWalkWarps - 1 ? kstage[(ww + 1) * kSpanWords]
                                   : edge[1];
    }
    // A check a row.  Written without it, as one mask applied after the
    // loop, the same marks gave wrong groups' values on the H100 (nvcc 12.9;
    // PERF.md, Findings), a fault not traced further.
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
  unsigned head_lanes = 0;  // lanes of the warp whose rows hold a head
  int tails_before = 0;
  if (walker) {
    head_lanes = __ballot_sync(grs::kFullWarp, heads != 0u);
    int warp_tails;
    tails_before = grs::warp_exclusive_scan(__popc(tails), lane, warp_tails);
    const int last = __reduce_max_sync(grs::kFullWarp, heads ? prow + 32 - __clz(heads) : 0);
    if (lane == 0) {
      wtails[ww] = warp_tails;
      wlast[ww] = last;
    }
  }
  __syncthreads();
  GRS_MARK(2, walker && wt == 0);
  int slot0 = tails_before;  // the thread's first group's slot in the partition
  int groups = 0;            // the groups ending in the partition
  int last_head = 0;         // 1 + the partition's last head's row, or 0
  unsigned wheads = 0;       // bit w: walking warp w's rows hold a head
#pragma unroll
  for (int w = 0; w < kWalkWarps; ++w) {
    slot0 += w < ww ? wtails[w] : 0;
    groups += wtails[w];
    last_head = wlast[w] > last_head ? wlast[w] : last_head;
    wheads |= static_cast<unsigned>(wlast[w] != 0) << w;
  }

  // 3. The partition's aggregate: each accumulator over its last run's rows.
  if (walker) {
    const int from = last_head > 0 ? last_head - 1 : 0;  // the last run's first row
    const bool in_run = (ww + 1) * kSpan > from;       // alike in the warp
    const int skip = from - prow;                        // rows of the thread before it
    const unsigned fold = (nlive > 0 ? (1u << nlive) - 1u : 0u) &
                          (skip <= 0 ? ~0u : (skip >= kItems ? 0u : ~0u << skip));
    if (in_run) {
      each_acc(spec, cstage, mine, [&](int a, auto acc, const auto& x) {
        using A = decltype(acc);
        using T = typename A::T;
        T s = A::zero();
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const T v = A::of(x[j]);
          s = ((fold >> j) & 1u) ? A::op(s, v) : s;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s = A::op(s, __shfl_xor_sync(grs::kFullWarp, s, o));
        if (lane == 0) wagg[a * kWalkWarps + ww] = to_bits(s);
      });
    } else if (lane < spec.nacc) {  // rows before the last run: the neutral element
      with_acc(spec.acc_kind[lane], [&](auto acc) {
        wagg[lane * kWalkWarps + ww] = to_bits(decltype(acc)::zero());
      });
    }
  }
  __syncthreads();
  GRS_MARK(3, walker && wt == 0);

  if (!walker) {
    // 4. The look-back warp: the aggregate published, the look-back, the
    // inclusive prefix published; then the walking warps may store.
    if (lane < spec.nacc) {
      with_acc(spec.acc_kind[lane], [&](auto acc) {
        using A = decltype(acc);
        using T = typename A::T;
        T s = A::zero();
#pragma unroll
        for (int w = 0; w < kWalkWarps; ++w) s = A::op(s, from_bits<T>(wagg[lane * kWalkWarps + w]));
        blk[lane] = to_bits(s);
        carry[lane] = to_bits(A::zero());
      });
    }
    __syncwarp();
    uint32_t base = 0;
    if (part > 0) {
      if (lane == 0) {
        for (int a = 0; a < spec.nacc; ++a) sc.agg[part * spec.nacc + a] = blk[a];
        store_release(sc.status + part,
                      grs::status_word(kAggregate | (wheads ? kHead : 0u),
                                       static_cast<uint32_t>(groups)));
      }
      __syncwarp();
      GRS_MARK(4, lane == 0);
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
      if (count_out != nullptr && live - 1 < first + kPartition)
        *count_out = static_cast<int32_t>(base + static_cast<uint32_t>(groups));
    }
    GRS_MARK(5, lane == 0);
    if (groups == 0) return;
    // A bar.sync, not a bar.arrive, which orders no shared-memory write
    // before the walking warps' reads of the carry and the group base.
    bar_sync(kBarJoin, kThreads);
    if (groups <= kSparseGroups) return;  // the walking warps store a sparse partition
    // A dense one: the warp helps copy its outputs out.
  } else {
    if (groups == 0) {  // nothing to store: the look-back warp finishes alone
      GRS_MARK(9, wt == 0);
      return;
    }
    walk(spec, cstage, mine, heads, tails, head_lanes, wheads, slot0, groups, lane, ww,
         wt, raw, excl, wtot, wexcl);
    GRS_MARK(7, wt == 0);
    bar_sync(kBarJoin, kThreads);  // the look-back warp has published the carry
    GRS_MARK(8, wt == 0);
  }

  // 6. The outputs.
  const int64_t base = group_base;
  const bool head_before = (head_lanes & ((1u << lane) - 1u)) != 0u;  // in lanes below
  const bool warp_head_before = (wheads & ((1u << ww) - 1u)) != 0u;
  if (groups <= kSparseGroups) {
    // Each thread's first run end takes the carry into the thread, where its
    // run began before the thread; then every output of every group,
    // finished from its accumulators, in order.
    const unsigned open_first = tails & (heads ? (heads & (0u - heads)) - 1u : ~0u);
    if (open_first != 0u) {
      for (int a = 0; a < spec.nacc; ++a) {
        with_acc(spec.acc_kind[a], [&](auto acc) {
          using A = decltype(acc);
          using T = typename A::T;
          unsigned long long& r = raw[a * kSparseGroups + slot0];
          r = to_bits(A::op(carry_into<A>(carry, wexcl, excl, a, wt, warp_head_before,
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
    bar_sync(kBarWalk, kWalkThreads);
    for (int i = wt; i < spec.nout * groups; i += kWalkThreads) {
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
    GRS_MARK(9, wt == 0);
    return;
  }
  // A dense partition: for the group keys and each output, every walking
  // thread walks its rows again from its carry and stages each run end's
  // value at its slot, and the whole block, the look-back warp too, copies
  // them out in order.
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
    const uint32_t* vals = cstage + (c < 0 ? 0 : c) * kStageWords + mine;
    if (tails != 0u) {
      with_acc(spec.acc_kind[a], [&](auto acc) {
        using A = decltype(acc);
        using T = typename A::T;
        T s = carry_into<A>(carry, wexcl, excl, a, wt, warp_head_before, head_before);
        uint32_t cnt = 0;  // a mean's rows in the run so far
        if (cn >= 0)
          cnt = carry_into<SumU32>(carry, wexcl, excl, cn, wt, warp_head_before, head_before);
        int slot = slot0;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {  // rows past the live ones: as in walk()
          const T x = A::of(c < 0 ? 0u : vals[j]);
          const bool head = (heads >> j) & 1u;
          s = head ? x : A::op(s, x);
          cnt = head ? 1u : cnt + 1u;
          if ((tails >> j) & 1u) ostage[slot++] = finish<A>(s, cn >= 0, cnt);
        }
      });
    }
    __syncthreads();
    uint32_t* out = spec.out[o];
    for (int s = tid; s < groups; s += kThreads) out[base + s] = ostage[s];
    __syncthreads();
  }
  GRS_MARK(9, wt == 0 && walker);
}

size_t shared_bytes(int ncol, int nacc) {
  return sizeof(uint32_t) * (static_cast<size_t>(1 + ncol) * kStageWords + kPartition) +
         sizeof(unsigned long long) * static_cast<size_t>(nacc) * (kWalkThreads + 3 * kWalkWarps);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// keys: n uint32 (4-byte aligned), sorted, the live rows first; 0 <= n <=
// INT_MAX.  live_ptr: null, or an int32 on the card holding the live rows;
// else live_value holds them (either is clamped to [0, n]).  rows: null, or
// n int32 (4-byte aligned): row i of every column is its element rows[i],
// clamped to the column's rows.  spec: num_words int64 words, read here
// before the launch: ncol, nacc, nout; ncol (address, rows) pairs (4-byte
// rows, 4-byte aligned; at least n rows without `rows`, at least one with
// it); nacc (kind, column) pairs (AccKind; column -1 for kCount, else below
// ncol); nout (address, accumulator, count accumulator) triples (an output
// of n 4-byte rows; the count accumulator -1, or a kCount one beside a
// float64 sum, for a mean).  ncol <= 8, nacc <= 9, nout <= 8.  keys_out:
// null, or the group keys (n uint32); count_out: null, or the group count
// (one int32).  Every output is zeroed here on the stream, then the kernel
// writes the groups' rows.  scratch: scratch_words int64 words, 8-byte
// aligned, at least 1 + parts * (1 + 2 nacc) for parts = ceil(n /
// kPartition) (kernels/aggregate.py::PARTITION); its first 1 + parts are
// cleared here.  Returns the first error of the memsets and the launch, or
// cudaGetLastError() after it.
extern "C" int grs_segment_aggregate(const void* keys, int64_t n, const void* live_ptr,
                                     int64_t live_value, const void* rows,
                                     const int64_t* spec_words, int num_words, void* keys_out,
                                     void* count_out, void* scratch, int64_t scratch_words,
                                     void* stream) {
  if (keys == nullptr || !aligned(keys, 4) || n < 0 || n > INT_MAX || spec_words == nullptr ||
      num_words < 3 || scratch == nullptr || !aligned(scratch, 8) ||
      (live_ptr != nullptr && !aligned(live_ptr, 4)) || (rows != nullptr && !aligned(rows, 4)) ||
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
      num_words != 3 + 2 * spec.ncol + 2 * spec.nacc + 3 * spec.nout) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* w = spec_words + 3;
  for (int c = 0; c < spec.ncol; ++c, w += 2) {
    spec.col[c] = reinterpret_cast<const uint32_t*>(w[0]);
    spec.col_rows[c] = w[1];
    if (spec.col[c] == nullptr || !aligned(spec.col[c], 4) ||
        spec.col_rows[c] < (rows != nullptr ? 1 : n))
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
      static_cast<const uint32_t*>(rows), spec, static_cast<uint32_t*>(keys_out),
      static_cast<int32_t*>(count_out), sc);
  return static_cast<int>(cudaGetLastError());
}

#ifdef GRS_TRACE
// The traced build's clocks, GRS_TRACE_PARTS x GRS_TRACE_STEPS int64 into
// dst (host memory), then cleared; marks a block did not reach stay 0.
extern "C" int grs_segment_aggregate_trace(void* dst, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyFromSymbolAsync(dst, grs_trace, sizeof(grs_trace), 0,
                                              cudaMemcpyDeviceToHost, s);
  void* at = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, grs_trace);
  if (err == cudaSuccess) err = cudaMemsetAsync(at, 0, sizeof(grs_trace), s);
  return static_cast<int>(err);
}
#endif
