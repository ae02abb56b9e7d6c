// Flat-cull traversal (K2) for Hopper: closest hit and any-hit, no tree walk.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_pallas3.py::_kernel3
// (pallas_call at :526; entries closest_hit_pallas3 :612, occluded_pallas3
// :638, merged closest_and_occluded_pallas3 :1119). Its plain PyTorch
// version, which this kernel must equal bit for bit, is
// ops/traverse_flat.py::plain(K2, ...): the group masks (flat_leaf_masks)
// AND each lane's own slab test (ray_leaf_hits), then _flush per lane.
//
// What it computes: the rays arrive as one packed (8, n) operand [ro3,
// rd3, tmin, tmax]. Every group of 128 consecutive lanes (one block)
// reduces its packet bounds over its live lanes (origin box,
// inverse-direction box, min tmin, max tmax, as group_bounds does) and
// tests that union packet against every leaf AABB with the conservative
// interval test of _kernel3 (flat_cull.cuh::survives). Each lane then
// takes the closest hit (t, row, u, v; a miss: t = 2e32, row = -1, u = v =
// 0) or the any-hit flag over the group's surviving leaves that its own
// exact slab test enters: K3's function, reached through a group broad
// phase. The group test keeps every leaf a lane's slab test enters (its
// entry bound is a lower bound of the lane's, flat_cull.cuh), so the
// result equals K3's and K1's bit for bit; it differs from the reference's
// function (every survivor tested for every lane of the group) only on
// grazing lanes, where the hit lies on the leaf box's boundary and the
// lane's own slab test misses the box (ROADMAP queue 3). Warps whose
// lanes lie at or past ``shadow_lane`` take the any-hit exit, so one
// launch can carry a closest queue in its first lanes and a shadow queue
// after it (the merged mode); any-hit lane i writes blocked[i -
// shadow_lane].
//
// What bounds it on this card: the Moller-Trumbore work of the (lane,
// leaf) pairs it tests, ~54 flops per triangle, then the broad phase
// (~60 flops per leaf box per group) and the per-lane box test of each
// survivor (~25 flops). This kernel's first design tested every row of
// every survivor for every lane of a 128-lane group, in no useful order,
// behind two block barriers per leaf. On an NVIDIA H100 80GB HBM3 at 700
// W, kernel-only (PERF.md, chip_smoke.py): terrain200's 2,097,152 frame
// primaries 1.85 ms in that design, 0.76 ms in this one (bound 0.146 ms
// over real rows, K1 1.10 ms); the village's 2.23 -> 0.51 ms; a sorted
// bounce-1 queue merged with a sun shadow queue 78.7 -> 2.33 ms. nvcc: 64,
// 72 and 72 registers at leaf 32, 64 and 128 (8 bytes of spill at 128).
//
// Design: a block of 4 warps is one broad-phase group (of groups of 32,
// 64 and 128 lanes, 128 was the fastest on the primaries, the queue the
// renderer gives K2: PERF.md). The broad phase runs one thread per leaf;
// the survivors' keys (entry bound lb, leaf) go to the block's list in
// shared memory, 8 bytes a leaf, and the block sorts them
// (flat_cull.cuh::sort_keys); that is the last barrier. Then each warp
// walks the sorted list on its own, as K3 walks every leaf: the lanes'
// cursors step together, one survivor a step, each lane's slab test of its
// segment [tmin, leaf_cap(best t)] decides whether it holds the leaf,
// __ballot_sync collects the holders, and serve_leaves (tlas_walk.cuh)
// tests the held leaf with RowTiles and the counted scan, up to the leaf's
// real-row count. A lane's box test and its stop take its best t raised
// by 2^-20 of itself (flat_cull.cuh::leaf_cap: a hit on a box's face can
// lie an ulp before the box's f32 entry, as on rays along leaf-box faces
// with a zero direction component). The warp stops at the first survivor
// whose lb exceeds that of every lane still walking (strictly: a leaf
// whose lb equals it may hold an exact-t tie with a lower row). Leaves are
// visited by lb, not by index, so a lane takes a hit that ties its best t
// when its row is lower: before a held leaf whose rows lie below the
// lane's best row, the lane's best t is raised by one ulp for the test
// (then restored if the leaf gave no hit), so the warp's tests and the
// strict merge of serve_leaves keep the first least (t, row), the
// lexicographic merge of the plain version. Any-hit mode stops a lane at
// its first hit and the warp once all its lanes are done.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py), no fast math, so results compare
// bitwise with the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flat_cull.cuh"
#include "tlas_walk.cuh"

namespace {

using rptr_stream::Best;
using rptr_stream::Ray;
using rptr_tlas::kFull;
using namespace rptr_flat;

constexpr int kThreads = 128;  // threads per block: one broad-phase group
constexpr int kWarps = kThreads / 32;
// a block's survivor list: 48 KB less 1 KB for the static part
constexpr int kSmemCap = 47 * 1024;

// One warp's walk of its group's ``count`` sorted survivors ``keys``
// (shared memory): each lane's best hit or blocked flag
template <bool kAnyHit, int kLS>
__device__ __forceinline__ Best narrow(const unsigned long long* keys,
                                       int count, const float* __restrict__ aabbs,
                                       int lpad, const rptr_tlas::RowTiles<kLS>& tiles,
                                       const int* __restrict__ real_rows,
                                       int scan_from, const Ray& r, bool live) {
  Best b{r.tmax, -1, 0.0f, 0.0f, false};
  bool done = !live;
  int s = 0;
  for (;;) {
    bool holds = false;
    unsigned hold = 0;
    int leaf = 0;
    for (; s < count; ++s) {
      const unsigned long long key = keys[s];  // one address: a broadcast
      // the keys ascend, so a lane past this leaf's lb is past every later one
      const float cap = leaf_cap(b.t);
      const bool past = done || key_lb(key) > cap;
      if (__all_sync(kFull, past)) {
        s = count;
        break;
      }
      leaf = key_leaf(key);
      holds = !past && enters(aabbs, lpad, leaf, r, cap);
      hold = __ballot_sync(kFull, holds);
      if (hold) break;
    }
    if (s >= count) break;
    const int row0 = leaf * kLS;
    const float t_keep = b.t;
    const int row_keep = b.row;
    // an exact-t tie in a leaf of lower rows than the best's wins
    if (!kAnyHit && holds && b.row > row0) b.t = nextafterf(b.t, INFINITY);
    rptr_tlas::serve_leaves<kAnyHit, rptr_tlas::RowTiles<kLS>, true>(
        holds, hold, tiles, r, leaf, row0, scan_from, b, real_rows);
    if (!kAnyHit && b.row == row_keep) b.t = t_keep;
    if (kAnyHit && b.blocked) done = true;
    ++s;
  }
  return b;
}

// One block is one broad-phase group of kThreads lanes, its survivor list
// ``num_leaves`` keys of dynamic shared memory; lanes at or past n are dead
template <int kLS>
__global__ void __launch_bounds__(kThreads) flat_cull_kernel(
    const float* __restrict__ aabbs, int lpad, int num_leaves,
    const float* __restrict__ rows, const int* __restrict__ real_rows,
    const float* __restrict__ rays, int n, int shadow_lane, int scan_from,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  extern __shared__ unsigned long long keys[];
  __shared__ float part[kBoundsN][kWarps];
  __shared__ int count;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  Ray r{};  // a lane past n: a zero, dead ray
  if (i < n) r.load(rays, n, i);
  const bool live = r.tmax > r.tmin;

  // ---- the group's packet bounds over its live lanes
  float pb[kBoundsN];
  warp_bounds(r, live, pb);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kBoundsN; ++k) part[k][w] = pb[k];
  }
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kBoundsN; ++k) {
    float acc = part[k][0];
#pragma unroll
    for (int v = 1; v < kWarps; ++v)
      acc = is_min(k) ? fminf(acc, part[k][v]) : fmaxf(acc, part[k][v]);
    pb[k] = acc;
  }

  // ---- broad phase: the union packet against every leaf box, one thread
  // per leaf; an all-dead group (tmax max <= tmin min) keeps no leaf
  if (pb[13] > pb[12]) {
    for (int l0 = 0; l0 < num_leaves; l0 += kThreads) {
      const int l = l0 + threadIdx.x;
      float lb = 0.0f;
      const bool keep = l < num_leaves && survives(pb, aabbs, lpad, l, lb);
      const unsigned ballot = __ballot_sync(kFull, keep);
      int base = 0;
      if (lane == 0 && ballot) base = atomicAdd(&count, __popc(ballot));
      base = __shfl_sync(kFull, base, 0) + __popc(ballot & ((1u << lane) - 1u));
      if (keep) keys[base] = leaf_key(lb, l);
    }
  }
  __syncthreads();
  const int survivors = count;
  sort_keys(keys, survivors);

  // ---- narrow phase: each warp on its own, no barrier from here on
  if (i - lane >= n) return;  // a warp wholly past n
  const rptr_tlas::RowTiles<kLS> tiles{rows};
  const bool shadow = i - lane >= shadow_lane;  // uniform over the warp
  if (shadow) {
    const Best b = narrow<true, kLS>(keys, survivors, aabbs, lpad, tiles,
                                     real_rows, scan_from, r, live);
    if (i < n) out_blocked[i - shadow_lane] = b.blocked ? 1 : 0;
  } else {
    const Best b = narrow<false, kLS>(keys, survivors, aabbs, lpad, tiles,
                                      real_rows, scan_from, r, live);
    if (i < n) {
      out_t[i] = b.row < 0 ? rptr_stream::kTMax : b.t;
      out_row[i] = b.row;
      out_u[i] = b.u;
      out_v[i] = b.v;
    }
  }
}

template <int kLS>
int launch(size_t smem, const float* aabbs, int lpad, int num_leaves,
           const float* rows, const int* real_rows, const float* rays, int n,
           int shadow_lane, int scan_from, float* out_t, int* out_row,
           float* out_u, float* out_v, unsigned char* out_blocked,
           cudaStream_t s) {
  flat_cull_kernel<kLS><<<(n + kThreads - 1) / kThreads, kThreads, smem, s>>>(
      aabbs, lpad, num_leaves, rows, real_rows, rays, n, shadow_lane,
      scan_from, out_t, out_row, out_u, out_v, out_blocked);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. ``rays`` is (8, n) f32, n a multiple of q (the
// reference's group, a multiple of 32 up to 1024). Blocks of 128 lanes are
// the broad phase's groups; a block's survivor list takes 8 bytes a leaf
// of shared memory, at most kSmemCap. Lanes from ``shadow_from * q`` on
// run the any-hit mode and write ``blocked`` (their lanes' worth), the
// lanes before it t, row, u, v: a closest launch is shadow_from >= n / q,
// an any-hit launch 0; a split inside the operand falls on a multiple of
// 128, between groups. ``leaf_size``: 32, 64 or 128 rows; ``rows`` aligned
// to 16 bytes at 128, 8 at 64; ``real_rows``: each leaf's real-row count.
// ``scan_from``: a leaf that this many lanes of a warp hold is tested by
// each of them alone (> 32: never). Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for operands
// it does not take, the leaf count past the cap among them. The caller
// allocates every output.
extern "C" int rptr_traverse_flat_cull(
    const float* aabbs, int lpad, int num_leaves, const float* rows,
    int leaf_size, const float* rays, int n, int q, int shadow_from,
    float* out_t, int* out_row, float* out_u, float* out_v,
    unsigned char* out_blocked, void* stream, const int* real_rows,
    int scan_from) {
  if (n <= 0) return 0;
  if (q <= 0 || q > 1024 || q % 32 || n % q || shadow_from < 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned long long) * static_cast<size_t>(num_leaves);
  if (smem > static_cast<size_t>(kSmemCap)) return cudaErrorInvalidValue;
  const int shadow_lane = static_cast<long long>(shadow_from) * q < n
                              ? shadow_from * q : n;
  if (shadow_lane < n && shadow_lane % kThreads) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPTR_K2_LAUNCH(LS)                                                   \
  return launch<LS>(smem, aabbs, lpad, num_leaves, rows, real_rows, rays, n, \
                    shadow_lane, scan_from, out_t, out_row, out_u, out_v,    \
                    out_blocked, s)
  if (leaf_size == 128) RPTR_K2_LAUNCH(128);
  if (leaf_size == 64) RPTR_K2_LAUNCH(64);
  if (leaf_size == 32) RPTR_K2_LAUNCH(32);
#undef RPTR_K2_LAUNCH
  return cudaErrorInvalidValue;
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
