// K3: the global stable scatter of the bucketized runs.
//
// Replaces the Pallas kernel gpuradixsort_tpu/kernels/scatter.py::_window_kernel
// (called by scatter_runs).  After bucketize, tile t holds its digit-r run
// at local_off[t, r] = hist[t, 0] + ... + hist[t, r-1]; the run goes to
//   out[offsets[t, r] + j] = bucketized[t * tile + local_off[t, r] + j]
// for j < hist[t, r].
//
// Bound on the H100: HBM bytes, 16 a key: key and index each read once and
// written once, plus each tile's hist and offsets rows (2 * radix int32).  At
// radix 16 that is 4.85 / 80.76 / 481.38 us at 1M / 2^24 / 100M keys.
//
// The TPU kernel walks the (digit, tile) runs as a sequential grid with a
// host-made window plan, an SMEM meta table and a carried partial row,
// because the TPU has no random store.  The H100 has one, so there is no
// plan, no window and no carry: every slot p of a tile goes straight to
// delta[r] + p, where r is the run holding p and delta[r] = offsets[t, r] -
// local_off[t, r].
//
// The first design (one 256-thread block a tile) lost time to a serial
// prologue in every block (the row loads, a barrier, thread 0 alone turning
// the rows into run ends and deltas, a second barrier) with no key load in
// flight, and to a dependent chain per slot (a load, a binary search through
// shared memory, a store), so a thread's loads were not in flight before its
// first store.  This design, like K2 and K4 (bucketize.cu, radix_dest.cu):
//   - one warp a tile, 8 tiles a block, no block barrier;
//   - lane r loads the rows' entry r together with the tile's keys and
//     indices; one warp scan gives local_off, so lane r holds run r's end and
//     delta, and the row needs no serial work;
//   - on the default 1,024-key tile (scatter_1k_kernel) a lane loads its 32
//     keys and 32 indices warp-striped (lane l's item j is element 32 j + l)
//     into registers before it stores any;
//   - the run ends are broadcast to every lane once a tile (radix - 1
//     shuffles); a slot's run is the count of ends at or below its position,
//     by unrolled compares, and its delta one shuffle from the run's lane.
//     A store instruction covers 32 neighbouring slots, one or two runs, so
//     the stores stay coalesced.
// Run r of tile t and run r of tile t + 1 are neighbours in the output, and
// the 32-byte sector between them is written half by each.  When the two
// tiles are placed close in time the halves meet in L2; when not, the card
// writes a part sector.  So the warps are not persistent: one tile a warp,
// and the block scheduler hands the tiles out in order.  Persistent warps
// that walked the tiles grid-stride, or a contiguous chunk each, drifted
// apart and measured 7-61% slower (PERF.md, Findings).  Built with
// -DGRS_SCATTER_CP_ASYNC, the tile instead arrives in a warp's shared buffer
// by cp.async (16-byte copies where the inputs allow); kernel_ab.py --sweep
// times both routes at GRS_SCATTER_WARPS tiles a block.  Any other tile or a
// radix above 16 (scatter_any_kernel) takes a warp-private row in shared
// memory, and each lane walks its runs forward, as its positions only grow.
//
// Nothing can overflow; a destination outside [0, n) (possible only for an
// inconsistent hist/offsets pair) is dropped, as JAX's mode="drop" drops it.
//
// In a fused sort the kernel follows the sort's pass plan (key_bits.cu): a
// skipped pass returns at once and writes nothing.  Every pass that runs
// writes the sort's result buffer, also where that buffer was the pass's
// source: bucketize has read it into the bucketized tiles before this
// launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

#ifndef GRS_SCATTER_WARPS
#define GRS_SCATTER_WARPS 8
#endif

namespace {

constexpr int kWarps = GRS_SCATTER_WARPS;  // tiles a block
constexpr int kFastTile = 1024;            // the default tile: 32 keys a lane
constexpr int kItems = kFastTile / 32;
constexpr int kFastMaxRadix = 16;
constexpr int kMaxRadix = 256;
constexpr int kBatch = 32;  // items a lane loads before it stores them (other tiles)

static_assert(kWarps >= 1 && kWarps <= 8, "GRS_SCATTER_WARPS must be 1-8");

// offsets - local_off, clamped so that delta + p never overflows for p < tile
// and stays out of [0, n) exactly when the true value is (n <= INT_MAX - tile).
__device__ __forceinline__ int run_delta(int offset, int local, int tile) {
  const long long d = static_cast<long long>(offset) - local;
  const long long lo = -(1LL << 30), hi = INT_MAX - tile;
  return static_cast<int>(d < lo ? lo : (d > hi ? hi : d));
}

// Loads that stay ahead of the tile's stores.  ptxas sinks a load that it
// knows no store can alias (ld.global.nc, or any load from shared memory)
// down to its one use, the range-checked store, and then a lane's loads no
// longer overlap: K3 took about 35% longer at 2^24 keys on an H100 80GB
// HBM3 (PERF.md, Findings).  A coherent global load, or a generic load of
// the shared buffer, may alias the stores, so ptxas leaves it in place.
__device__ __forceinline__ uint32_t load_global(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t load_generic(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool in_range(int dst, int n) {
  return static_cast<unsigned>(dst) < static_cast<unsigned>(n);
}

// Places one 1,024-key tile from registers.  Lane r < kRadix brings entry r
// of the tile's hist and offsets rows (h, o); k and v are the lane's items.
template <int kRadix>
__device__ __forceinline__ void place_1k(const uint32_t (&k)[kItems],
                                         const uint32_t (&v)[kItems], int h, int o,
                                         int lane, uint32_t* __restrict__ out_keys,
                                         uint32_t* __restrict__ out_idx, int n) {
  int total;
  const int local = grs::warp_exclusive_scan(h, lane, total);
  const int end = local + h;  // lane r: the end of run r
  const int delta = run_delta(o, local, kFastTile);
  // end[r] - lane: item j's slot 32 j + lane lies at or past end[r] when
  // this is <= 32 j.  The last end needs no compare: a slot past it stays in
  // the last run, as the plain version's clamp keeps it.
  int ends[kRadix - 1];
#pragma unroll
  for (int r = 0; r < kRadix - 1; ++r) ends[r] = __shfl_sync(grs::kFullWarp, end, r) - lane;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    int run = 0;
#pragma unroll
    for (int r = 0; r < kRadix - 1; ++r) run += ends[r] <= 32 * j;
    const int dst = __shfl_sync(grs::kFullWarp, delta, run) + 32 * j + lane;
    if (in_range(dst, n)) {
      out_keys[dst] = k[j];
      out_idx[dst] = v[j];
    }
  }
}

template <int kBits>
__global__ void __launch_bounds__(32 * kWarps)
    scatter_1k_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ idx,
                      const int32_t* __restrict__ hist, const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ plan, int pass,
                      uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_idx,
                      int64_t num_tiles, int n, bool vec) {
  constexpr int kRadix = 1 << kBits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= num_tiles || grs::plan_source(plan, pass) < 0) return;  // no block barrier follows
  const int h = lane < kRadix ? hist[t * kRadix + lane] : 0;
  const int o = lane < kRadix ? offsets[t * kRadix + lane] : 0;
  uint32_t k[kItems], v[kItems];
#ifdef GRS_SCATTER_CP_ASYNC
  extern __shared__ uint4 smem[];  // per warp: the input tile, keys then indices
  uint32_t* in = reinterpret_cast<uint32_t*>(smem) + static_cast<size_t>(warp) * 2 * kFastTile;
  grs::load_tile<kFastTile>(in, keys, idx, t, lane, vec);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = load_generic(in + 32 * j + lane);
    v[j] = load_generic(in + kFastTile + 32 * j + lane);
  }
#else
  (void)vec;  // the register route loads 4 bytes a lane, at any alignment
  const uint32_t* kin = keys + t * kFastTile + lane;
  const uint32_t* vin = idx + t * kFastTile + lane;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = load_global(kin + 32 * j);
    v[j] = load_global(vin + 32 * j);
  }
#endif
  place_1k<kRadix>(k, v, h, o, lane, out_keys, out_idx, n);
}

__global__ void __launch_bounds__(32 * kWarps)
    scatter_any_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ idx,
                       const int32_t* __restrict__ hist, const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ plan, int pass,
                       uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_idx,
                       int64_t num_tiles, int tile, int radix, int n) {
  extern __shared__ int rows[];  // per warp: the run ends, then the deltas
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= num_tiles || grs::plan_source(plan, pass) < 0) return;  // no block barrier follows

  int* ends = rows + 2 * radix * warp;
  int* delta = ends + radix;
  const int32_t* hrow = hist + t * radix;
  const int32_t* orow = offsets + t * radix;
  int carry = 0;
  for (int r0 = 0; r0 < radix; r0 += 32) {  // alike in every lane
    const int r = r0 + lane;
    const int h = r < radix ? hrow[r] : 0;
    const int o = r < radix ? orow[r] : 0;
    int total;
    const int local = carry + grs::warp_exclusive_scan(h, lane, total);
    if (r < radix) {
      ends[r] = local + h;
      delta[r] = run_delta(o, local, tile);
    }
    carry += total;
  }
  __syncwarp();

  const uint32_t* kin = keys + t * tile + lane;
  const uint32_t* vin = idx + t * tile + lane;
  const int items = tile >> 5;
  int run = 0;  // this lane's run; its positions only grow
  for (int j0 = 0; j0 < items; j0 += kBatch) {
    uint32_t k[kBatch], v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j0 + j < items) {
        k[j] = kin[32 * (j0 + j)];
        v[j] = vin[32 * (j0 + j)];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j0 + j < items) {
        const int p = 32 * (j0 + j) + lane;
        while (run < radix - 1 && ends[run] <= p) ++run;
        const int dst = delta[run] + p;
        if (in_range(dst, n)) {
          out_keys[dst] = k[j];
          out_idx[dst] = v[j];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One block per kWarps tiles.
template <int kBits>
cudaError_t launch_1k(const uint32_t* keys, const uint32_t* idx, const int32_t* hist,
                      const int32_t* offsets, const int32_t* plan, int pass,
                      uint32_t* out_keys, uint32_t* out_idx, int64_t num_tiles, int n,
                      cudaStream_t stream) {
  const auto kernel = scatter_1k_kernel<kBits>;
#ifdef GRS_SCATTER_CP_ASYNC
  const size_t smem = static_cast<size_t>(kWarps) * 2 * kFastTile * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
#else
  const size_t smem = 0;
#endif
  kernel<<<static_cast<unsigned>((num_tiles + kWarps - 1) / kWarps), 32 * kWarps, smem,
           stream>>>(keys, idx, hist, offsets, plan, pass, out_keys, out_idx, num_tiles, n,
                     aligned16(keys) && aligned16(idx));
  return cudaSuccess;
}

}  // namespace

// keys, idx, out_keys, out_idx: num_tiles * tile uint32 (4-byte aligned);
// hist, offsets: (num_tiles, radix) int32.  tile is a positive multiple of
// 32, radix 1-256, and num_tiles * tile at most INT_MAX - tile (int32
// destinations).  The 1,024-key tile at a power-of-two radix up to 16 takes
// the register route; any other geometry keeps 8 * radix bytes a warp in
// shared memory.  plan: null, or a fused sort's pass plan on the device, of
// which entry `pass` says whether this launch runs.  Returns
// cudaGetLastError() after the launch.
extern "C" int grs_scatter_runs(const void* keys, const void* idx,
                                const void* hist, const void* offsets,
                                void* out_keys, void* out_idx,
                                int64_t num_tiles, int tile, int radix,
                                const void* plan, int pass, void* stream) {
  if (radix < 1 || radix > kMaxRadix || tile <= 0 || tile % 32 != 0 || num_tiles < 0 ||
      (num_tiles > 0 && num_tiles > (INT_MAX - tile) / tile) ||
      (plan != nullptr && pass < 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* v = static_cast<const uint32_t*>(idx);
  const auto* h = static_cast<const int32_t*>(hist);
  const auto* o = static_cast<const int32_t*>(offsets);
  auto* ok = static_cast<uint32_t*>(out_keys);
  auto* ov = static_cast<uint32_t*>(out_idx);
  const auto* pl = static_cast<const int32_t*>(plan);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(num_tiles * tile);
  cudaError_t err = cudaSuccess;
  if (tile == kFastTile && radix <= kFastMaxRadix && (radix & (radix - 1)) == 0 && radix >= 2) {
    switch (__builtin_ctz(static_cast<unsigned>(radix))) {
      case 1: err = launch_1k<1>(k, v, h, o, pl, pass, ok, ov, num_tiles, n, s); break;
      case 2: err = launch_1k<2>(k, v, h, o, pl, pass, ok, ov, num_tiles, n, s); break;
      case 3: err = launch_1k<3>(k, v, h, o, pl, pass, ok, ov, num_tiles, n, s); break;
      default: err = launch_1k<4>(k, v, h, o, pl, pass, ok, ov, num_tiles, n, s); break;
    }
  } else {
    const size_t smem = static_cast<size_t>(kWarps) * 2 * radix * sizeof(int);
    scatter_any_kernel<<<static_cast<unsigned>((num_tiles + kWarps - 1) / kWarps),
                         32 * kWarps, smem, s>>>(k, v, h, o, pl, pass, ok, ov, num_tiles, tile,
                                                 radix, n);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
