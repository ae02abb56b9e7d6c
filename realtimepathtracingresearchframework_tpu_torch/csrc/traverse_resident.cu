// Resident threaded-BVH walk (K1) for Hopper: closest hit, any-hit and the
// merged two-queue mode.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_pallas2.py::_kernel2
// (closest mode through closest_hit_pallas2, any-hit mode through
// occluded_pallas2, both queues through closest_and_occluded_pallas2). Its
// plain PyTorch version, which this kernel must equal bit for bit, is
// ops/traverse.py::walk_ranges.
//
// What it computes, per ray: walk the preorder node array from node 0.
// Enter a node when the slab test passes with t_far capped by the ray's best
// hit so far (tmax at the start); otherwise jump to the node's skip link. At
// a leaf, run Moller-Trumbore over its leaf_size rows in the expression
// order of traverse_pallas2._mt_leaf, with the |det| > 1e-12 guard and the
// hit test tt > tmin && tt < min(t_best, tmax). Closest mode keeps the
// nearest hit (strict improvement, so the lower row wins an exact-t tie)
// and writes t, row, u, v; a miss gives t = 2e32, row = -1, u = v = 0.
// Any-hit mode stops at the first hit and writes blocked = 1. The mode is
// per block of 128 rays: blocks from ``shadow_from`` on take the any-hit
// exit (all of them for an any-hit launch, none for a closest launch), so
// one launch can carry the wavefront's closest queue in its first blocks
// and the deferred shadow queue after it (the merged mode); any-hit lane i
// writes blocked[i - shadow_from * 128].
//
// Design: tlas_walk.cuh's walk_threaded, the template K8a and K8b run too.
// Each lane keeps its walk as resumable state (LaneWalk: cursor, best, the
// held leaf) and steps it to its next entered leaf with 8-byte node loads
// through the read-only path; then the warp serves the lanes' pending
// leaves (serve_leaves): a leaf that ``scan_from`` or more lanes of the warp
// hold (a coherent queue) is scanned by each holder in row order with
// broadcast loads up to the leaf's real-row count (a pack pads a leaf by
// repeating its last triangle, which can change no result), leaf_size / 32
// rows a step from 9 loads of 4, 8 or 16 bytes (RowTiles, K3's loader); any
// other is tested by the whole warp with a shuffle reduction to the first
// least hit: at leaf 128 lane j takes rows j, j + 32, ... up to the count
// (ceil(c / 32) steps for c real rows), at leaf 32 and 64 leaf_size / 32
// rows a lane, every row (one step a lane at 32 either way; faster so at
// 64, PERF.md). The first K1 ran one thread per ray, each scanning its own
// leaves with 9 scalar loads per row: as fast on cornell's one leaf, far
// behind the warp-shared test where lanes diverge (13.2 against 1.8 ms on
// terrain200's sorted bounce 1, PERF.md). Staging cornell's 1,152-byte row
// table in every block's shared memory, read as float4s, was measured and
// dropped: slower on every queue and table size (PERF.md). Ints stay ints:
// links and rows are int32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py). No fast math: with contraction off and
// IEEE division the arithmetic rounds exactly like the plain version's
// separate tensor ops, so results compare bitwise.
//
// What bounds it on this card: the Moller-Trumbore work of each ray's own
// leaves (54 flops a row) and how much of the warp does it, and on cornell,
// whose one leaf every ray holds, the holders' scan of its 32 rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tlas_walk.cuh"

namespace {

using rptr_stream::Best;
using rptr_stream::Ray;

constexpr int kBlock = 128;
constexpr int kScanFrom = 16;  // the default (PERF.md: measured on its queues)

template <int kLS>
__global__ void __launch_bounds__(kBlock) traverse_resident_kernel(
    rptr_tlas::Threaded t,
    const float* __restrict__ rows,  // (R, 9) v0, e1, e2
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, int shadow_from, int scan_from,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  // every lane stays to the end: the warp tests the leaves together
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  Ray r{};
  if (live) {
    r.ox = ox[i];
    r.oy = oy[i];
    r.oz = oz[i];
    r.dx = dx[i];
    r.dy = dy[i];
    r.dz = dz[i];
    r.tmin = tmin_in[i];
    r.tmax = tmax_in[i];
  }
  r.ix = rptr_stream::safe_inv(r.dx);
  r.iy = rptr_stream::safe_inv(r.dy);
  r.iz = rptr_stream::safe_inv(r.dz);
  const bool any_hit = static_cast<int>(blockIdx.x) >= shadow_from;
  const rptr_tlas::RowTiles<kLS> tiles{rows};
  const Best b =
      any_hit ? rptr_tlas::walk_threaded<true>(t, tiles, scan_from, r, live)
              : rptr_tlas::walk_threaded<false>(t, tiles, scan_from, r, live);
  if (!live) return;
  if (any_hit) {
    out_blocked[i - shadow_from * kBlock] = b.blocked ? 1 : 0;
  } else {
    out_t[i] = b.row < 0 ? rptr_stream::kTMax : b.t;
    out_row[i] = b.row;
    out_u[i] = b.u;
    out_v[i] = b.v;
  }
}

}  // namespace

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched). Blocks of 128 rays; blocks from
// ``shadow_from`` on run the any-hit mode and write ``blocked`` (n -
// shadow_from * 128 flags), the blocks before it t, row, u, v (their
// lanes' worth). Closest mode: shadow_from >= the grid; any-hit: 0.
// ``leaf_size``: 32, 64 or 128 rows (``rows`` aligned to 4 * leaf_size / 32
// bytes, ``bounds`` and ``links`` to 8); ``counts`` each leaf's real-row
// count; ``scan_from`` as in tlas_walk.cuh::serve_leaves (< 0: the
// default). The caller allocates every output; the result does not depend
// on ``scan_from``.
extern "C" int rptr_traverse_resident(
    const float* bounds, const int* links, const int* counts,
    const float* rows, int num_nodes, int leaf_size, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmin, const float* tmax, int n,
    int shadow_from, float* out_t, int* out_row, float* out_u, float* out_v,
    unsigned char* out_blocked, void* stream, int scan_from) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  if (shadow_from < 0) return cudaErrorInvalidValue;
  if (shadow_from > grid) shadow_from = grid;
  if (scan_from < 0) scan_from = kScanFrom;
  const rptr_tlas::Threaded t{bounds, links, counts, num_nodes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPTR_K1_LAUNCH(LS)                                                   \
  traverse_resident_kernel<LS><<<grid, kBlock, 0, s>>>(                     \
      t, rows, ox, oy, oz, dx, dy, dz, tmin, tmax, n, shadow_from,         \
      scan_from, out_t, out_row, out_u, out_v, out_blocked)
  if (leaf_size == 128) {
    RPTR_K1_LAUNCH(128);
  } else if (leaf_size == 64) {
    RPTR_K1_LAUNCH(64);
  } else if (leaf_size == 32) {
    RPTR_K1_LAUNCH(32);
  } else {
    return cudaErrorInvalidValue;
  }
#undef RPTR_K1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
