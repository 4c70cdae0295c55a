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
// apart and measured 7-61% slower (PERF.md, Findings); so did a tile
// copied into shared memory by cp.async (kernel_ab.py of commit 6fc2579,
// --sweep).  Any other tile or a radix above 16 (scatter_any_kernel) takes
// a warp-private row in shared memory, and each lane walks its runs
// forward, as its positions only grow.
//
// Nothing can overflow; a destination outside [0, n) (possible only for an
// inconsistent hist/offsets pair) is dropped, as JAX's mode="drop" drops it.
//
// The place steps are grs::place_1k and grs::place_any (tile.cuh).  The
// fused sort's pass (bucketize_scatter.cu) does this kernel's work inside
// its own, so this one runs off the main path, beside its plain version and
// in the bench's stage table.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kWarps = 8;  // tiles a block
constexpr int kFastTile = grs::kFastTile;
constexpr int kItems = grs::kFastItems;
constexpr int kFastMaxRadix = 16;
constexpr int kMaxRadix = 256;

template <int kBits>
__global__ void __launch_bounds__(32 * kWarps)
    scatter_1k_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ idx,
                      const int32_t* __restrict__ hist, const int32_t* __restrict__ offsets,
                      uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_idx,
                      int64_t num_tiles, int n) {
  constexpr int kRadix = 1 << kBits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= num_tiles) return;  // no block barrier follows
  const int h = lane < kRadix ? hist[t * kRadix + lane] : 0;
  const int o = lane < kRadix ? offsets[t * kRadix + lane] : 0;
  uint32_t k[kItems], v[kItems];
  const uint32_t* kin = keys + t * kFastTile + lane;
  const uint32_t* vin = idx + t * kFastTile + lane;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = grs::load_global(kin + 32 * j);
    v[j] = grs::load_global(vin + 32 * j);
  }
  grs::place_1k<kRadix>(k, v, h, o, lane, out_keys, out_idx, n);
}

__global__ void __launch_bounds__(32 * kWarps)
    scatter_any_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ idx,
                       const int32_t* __restrict__ hist, const int32_t* __restrict__ offsets,
                       uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_idx,
                       int64_t num_tiles, int tile, int radix, int n) {
  extern __shared__ int rows[];  // per warp: the run ends, then the deltas
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= num_tiles) return;  // no block barrier follows

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
      delta[r] = grs::run_delta(o, local, tile);
    }
    carry += total;
  }
  __syncwarp();
  grs::place_any(keys + t * tile + lane, idx + t * tile + lane, tile >> 5, ends, delta, radix,
                 lane, out_keys, out_idx, n);
}

// One block per kWarps tiles.
template <int kBits>
cudaError_t launch_1k(const uint32_t* keys, const uint32_t* idx, const int32_t* hist,
                      const int32_t* offsets, uint32_t* out_keys, uint32_t* out_idx,
                      int64_t num_tiles, int n, cudaStream_t stream) {
  scatter_1k_kernel<kBits><<<static_cast<unsigned>((num_tiles + kWarps - 1) / kWarps),
                             32 * kWarps, 0, stream>>>(keys, idx, hist, offsets, out_keys,
                                                       out_idx, num_tiles, n);
  return cudaSuccess;
}

}  // namespace

// keys, idx, out_keys, out_idx: num_tiles * tile uint32 (4-byte aligned);
// hist, offsets: (num_tiles, radix) int32.  tile is a positive multiple of
// 32, radix 1-256, and num_tiles * tile at most INT_MAX - tile (int32
// destinations).  The 1,024-key tile at a power-of-two radix up to 16 takes
// the register route; any other geometry keeps 8 * radix bytes a warp in
// shared memory.  Returns cudaGetLastError() after the launch.
extern "C" int grs_scatter_runs(const void* keys, const void* idx,
                                const void* hist, const void* offsets,
                                void* out_keys, void* out_idx,
                                int64_t num_tiles, int tile, int radix, void* stream) {
  if (radix < 1 || radix > kMaxRadix || tile <= 0 || tile % 32 != 0 || num_tiles < 0 ||
      (num_tiles > 0 && num_tiles > (INT_MAX - tile) / tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* v = static_cast<const uint32_t*>(idx);
  const auto* h = static_cast<const int32_t*>(hist);
  const auto* o = static_cast<const int32_t*>(offsets);
  auto* ok = static_cast<uint32_t*>(out_keys);
  auto* ov = static_cast<uint32_t*>(out_idx);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(num_tiles * tile);
  cudaError_t err = cudaSuccess;
  if (tile == kFastTile && radix <= kFastMaxRadix && (radix & (radix - 1)) == 0 && radix >= 2) {
    switch (__builtin_ctz(static_cast<unsigned>(radix))) {
      case 1: err = launch_1k<1>(k, v, h, o, ok, ov, num_tiles, n, s); break;
      case 2: err = launch_1k<2>(k, v, h, o, ok, ov, num_tiles, n, s); break;
      case 3: err = launch_1k<3>(k, v, h, o, ok, ov, num_tiles, n, s); break;
      default: err = launch_1k<4>(k, v, h, o, ok, ov, num_tiles, n, s); break;
    }
  } else {
    const size_t smem = static_cast<size_t>(kWarps) * 2 * radix * sizeof(int);
    scatter_any_kernel<<<static_cast<unsigned>((num_tiles + kWarps - 1) / kWarps),
                         32 * kWarps, smem, s>>>(k, v, h, o, ok, ov, num_tiles, tile, radix, n);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
