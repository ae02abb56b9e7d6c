// Pre-cull traversal (K3) for Hopper: closest hit and any-hit on sorted
// queues, each lane culling the leaves for itself.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_pallas3.py::_kernel4
// (pallas_call at :1035; entries closest_hit_pallas4 :1063,
// occluded_pallas4 :1090) together with its XLA feeder leaf_masks_xla
// (:667), which built an (nb, Lpad) mask in device memory first. Its plain
// PyTorch version, which this kernel must equal bit for bit, is
// ops/traverse_flat.py::plain(K3, ...): per lane, ray_leaf_hits then
// _flush.
//
// What it computes, per lane: the closest hit (t, row, u, v; a miss: t =
// 2e32, row = -1, u = v = 0) or the any-hit flag over the leaves whose box
// the lane's own exact slab test enters (ray_leaf_hits: the segment [tmin,
// tmax], a box valid when lo.x <= hi.x), Moller-Trumbore on each of their
// rows in the expression order of traverse_pallas2._mt_leaf, hits in (tmin,
// tmax) merged on (t, row) lexicographically. That equals K1's walk bit
// for bit. The reference kernel tests, for every lane of a q-lane group,
// every leaf that ANY lane of the group enters; the merge is exact, so its
// result is the same whatever the group (ops/traverse_flat.py), and this
// kernel tests the group of one lane.
//
// What bounds it on this card: the Moller-Trumbore work of the (lane, leaf)
// pairs it tests, ~54 flops per triangle, then the per-lane box cull, ~25
// flops per leaf box (640 boxes at 80k tris). This kernel's first form,
// the reference's design, tested every leaf any lane of its 128-lane block
// entered for every lane of the block, before any hit was known, through
// a shared survivor list with two barriers per leaf: about 110 times the
// pairs a lane's own walk up to its closest hit needs, on a sorted bounce
// queue.
//
// Design: each warp works on its own (no shared memory, no barrier). The
// lanes' cursors over leaves 0..num_leaves-1 step together, one leaf box a
// step, which the warp reads once (a broadcast), in a tight loop of its own
// up to the next leaf some lane holds; each lane's exact slab test of its
// segment [tmin, leaf_cap(best t)] decides whether it holds the leaf: its
// best t so far raised by 2^-20 of itself (flat_cull.cuh), since a hit on a
// box's face can lie an ulp before the box's f32 entry, where a test capped
// at the best t alone would drop a hit that beats it by an ulp. The cap
// drops every leaf behind the lane's nearest hit.
// __ballot_sync collects the holders. Where fewer than ``scan_from`` lanes
// hold the leaf, the warp tests it for each holder in turn with
// tlas_walk.cuh's test_leaves on the row-major rows (RowTiles: lane j takes
// triangles ls/32 * j onwards, from 9 loads of 16, 8 or 4 bytes at leaf size
// 128, 64 or 32), which keeps the leaf's first least (t, k); where more hold
// it (a coherent queue), each holder tests the leaf's rows itself, all
// reading the same address (broadcast loads), in k order against its falling
// best, which keeps the same first least hit (tlas_walk.cuh gives the
// argument); the launcher's ``scan_from`` is 24 (ops/traverse_flat.py), > 32
// never scans. A lane takes a hit only when it is strictly nearer than its
// best, and it visits leaves in ascending index, whose rows ascend with leaf
// and k: so an exact-t tie keeps the lowest row, the lexicographic (t, row)
// merge. Any-hit mode stops a lane at its first hit, and the warp once all
// its lanes are done. An earlier form of this design stepped each lane's
// cursor to its own next leaf and served the warp's pending leaves together;
// the cursors drifted apart, so the warp walked the boxes more than once,
// read them at 32 addresses and lost to the reference's design on coherent
// primary and shadow queues; one loop around both the box steps and the leaf
// tests ran 4-6% slower than the tight box loop (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py), no fast math, so results compare
// bitwise with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_cull.cuh"
#include "tlas_walk.cuh"

namespace {

using rptr_flat::enters;
using rptr_stream::Best;
using rptr_stream::Ray;
using rptr_tlas::kFull;
using rptr_tlas::kMaxThreads;
using rptr_tlas::kNoTri;

template <bool kAnyHit, int kLS>
__global__ void __launch_bounds__(kMaxThreads) precull_kernel(
    const float* __restrict__ aabbs, int lpad, int num_leaves,
    const float* __restrict__ rows, const float* __restrict__ rays, int n,
    int scan_from, float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  // every lane stays to the end: the warp tests the leaves together
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r{};
  if (i < n) r.load(rays, n, i);
  Best b{r.tmax, -1, 0.0f, 0.0f, false};
  bool done = !(i < n && r.tmax > r.tmin);
  const rptr_tlas::RowTiles<kLS> tiles{rows};
  // the lanes' cursors step together, one leaf box a step (one broadcast
  // load of its six floats for the warp), in a loop of their own up to the
  // next leaf some lane holds, until every lane is done
  int l = __all_sync(kFull, done) ? num_leaves : 0;
  for (;;) {
    bool holds = false;
    unsigned hold = 0;
    for (; l < num_leaves; ++l) {
      holds = !done && enters(aabbs, lpad, l, r, rptr_flat::leaf_cap(b.t));
      hold = __ballot_sync(kFull, holds);
      if (hold) break;
    }
    if (l >= num_leaves) break;
    if (__popc(hold) >= scan_from) {
      // each holder tests the leaf's rows itself, all reading one address
      if (holds) rptr_tlas::scan_leaf<kAnyHit>(tiles, l, l * kLS, r, b);
    } else {
      const rptr_tlas::LeafHit h = rptr_tlas::test_leaves<kAnyHit>(
          hold, tiles, r, fminf(b.t, r.tmax), l);
      if (holds && h.k != kNoTri) {
        if (kAnyHit) {
          b.blocked = true;
        } else if (h.t < b.t) {
          b.t = h.t;
          b.row = l * kLS + h.k;
          b.u = h.u;
          b.v = h.v;
        }
      }
    }
    // only an any-hit lane ends before the last leaf
    if (kAnyHit) {
      if (b.blocked) done = true;
      if (__all_sync(kFull, done)) break;
    }
    ++l;
  }
  if (i >= n) return;
  if (kAnyHit) {
    out_blocked[i] = b.blocked ? 1 : 0;
  } else {
    out_t[i] = b.row < 0 ? rptr_stream::kTMax : b.t;
    out_row[i] = b.row;
    out_u[i] = b.u;
    out_v[i] = b.v;
  }
}

template <bool kAnyHit, int kLS>
void launch(int threads, const float* aabbs, int lpad, int num_leaves,
            const float* rows, const float* rays, int n, int scan_from,
            float* out_t, int* out_row, float* out_u, float* out_v,
            unsigned char* out_blocked, cudaStream_t s) {
  precull_kernel<kAnyHit, kLS><<<(n + threads - 1) / threads, threads, 0, s>>>(
      aabbs, lpad, num_leaves, rows, rays, n, scan_from, out_t, out_row, out_u,
      out_v, out_blocked);
}

}  // namespace

// Plain C entry for ctypes. ``q`` (a multiple of 32 up to 1024; the
// reference's group size) is the block size, up to 512 (larger groups run
// in blocks of 512); results do not depend on it. ``leaf_size``: 32, 64 or
// 128 rows; ``rows`` aligned to 16 bytes at 128, 8 at 64. ``scan_from``:
// a leaf that this many lanes of a warp hold is tested by each of them
// alone (> 32: never). any_hit != 0 writes only ``blocked``, otherwise only
// t, row, u, v. Launches on ``stream`` and returns cudaGetLastError() (0 =
// launched). The caller allocates every output.
extern "C" int rptr_traverse_precull(
    const float* aabbs, int lpad, int num_leaves, const float* rows,
    int leaf_size, const float* rays, int n, int q, int any_hit, float* out_t,
    int* out_row, float* out_u, float* out_v, unsigned char* out_blocked,
    void* stream, int scan_from) {
  if (n <= 0) return 0;
  if (q <= 0 || q > 1024 || q % 32 || n % q) return cudaErrorInvalidValue;
  const int threads = q < kMaxThreads ? q : kMaxThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPTR_K3_LAUNCH(A, LS)                                                \
  launch<A, LS>(threads, aabbs, lpad, num_leaves, rows, rays, n, scan_from, \
                out_t, out_row, out_u, out_v, out_blocked, s)
  if (leaf_size == 128) {
    if (any_hit) RPTR_K3_LAUNCH(true, 128); else RPTR_K3_LAUNCH(false, 128);
  } else if (leaf_size == 64) {
    if (any_hit) RPTR_K3_LAUNCH(true, 64); else RPTR_K3_LAUNCH(false, 64);
  } else if (leaf_size == 32) {
    if (any_hit) RPTR_K3_LAUNCH(true, 32); else RPTR_K3_LAUNCH(false, 32);
  } else {
    return cudaErrorInvalidValue;
  }
#undef RPTR_K3_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
