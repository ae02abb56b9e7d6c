// Streamed two-level walk (K4) for Hopper: closest hit and any-hit.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_stream.py::
// _kernel_streamed (:493, pallas_call at :781): the preorder walk
// (closest_hit_streamed, occluded_streamed, the cleanup dispatch of the
// binned traversals), the ordered walk (closest_hit_streamed(ordered=True),
// :650-715) and the 16-bit quantized tiles (quantized=True, :555-590). Its
// plain PyTorch version, which this kernel must equal bit for bit, is
// ops/traverse_stream.py::plain.
//
// What it computes, per ray: walk the top tree over the subtree boxes in
// preorder from node 0, entering a node when the slab test passes with
// t_far capped by the ray's best hit so far (tmax at the start); at a top
// leaf (payload = subtree id) walk that subtree and go on at the leaf's
// skip link. Hits improve strictly, so the first visited triangle keeps an
// exact-t tie. Closest mode writes t, global row, u, v (a miss: t = 2e32,
// row = -1, u = v = 0); any-hit mode stops at the first hit and writes
// blocked = 1. The mode is per block: blocks from ``shadow_from`` on take
// the any-hit exit, so one launch can carry a closest queue in its first
// blocks and a shadow queue after it (the merged mode,
// traverse_stream.closest_and_occluded_streamed :967); any-hit lane i
// writes blocked[i - shadow_from * kThreads]. An empty segment (tmax <=
// tmin) walks nothing.
//
// The ordered mode (closest only) visits a ray's subtrees nearest first
// instead: it re-walks the top tree for the live top leaf with the least
// (entry t, preorder index) above the last one visited
// (tlas_walk.cuh::next_ordered) and stops when none is entered within the
// ray's best t. Its results equal the preorder walk's except on exact-t ties
// across subtrees; its plain version is traverse_stream.plain_ordered. On a
// quantized pack the leaf test decodes the int16 codes with the subtree's
// grid constants (tlas_walk.cuh::QuantTiles).
//
// What bounds it on this card: the Moller-Trumbore work of every entered
// leaf (128 triangles, ~54 flops each) and how much of the warp does it,
// not device-memory bandwidth: the 500k-triangle pack (31 MiB of f32
// tiles, 15.5 MiB of int16) stays in the 50 MB L2. This kernel's first form
// ran one thread per ray through its own walks, each lane scanning the 128
// triangles of every leaf it entered alone with 9 dependent scalar loads
// per triangle; on a divergent queue each lane sat in another leaf, so the
// warp serialised on the walks and its loads touched up to 32 cache lines
// each.
//
// Design: K6's and K7's (tlas_walk.cuh), without an object ray. Each lane's
// walk is resumable state (rptr_tlas::Walk over a Scene whose subtrees are
// entered with the world ray), stepped to its next entered leaf; the warp
// then tests every lane's pending leaf in turn, 4 triangles a lane from 9
// coalesced loads per leaf (16 bytes a lane for f32 tiles, 8 for int16),
// and reduces to the first least hit, which equals the plain walk bit for
// bit (tlas_walk.cuh gives the argument). Lanes past n and ended walks stay
// in the loop until the ballot finds no leaf in the warp. The top tree
// (Mt nodes x 32 B: 4 KB at 64 subtrees) is staged in shared memory by
// each block and read with 16-byte loads; subtree nodes and tiles come from
// global memory through the read-only path. The TPU kernel's per-block
// packet bounds, scalar cursor, 16-leaf SMEM flush list, whole-subtree tile
// DMA into VMEM and its per-packet candidate list are TPU devices and are
// not carried over; per-ray results do not depend on them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py), no fast math, so results compare
// bitwise with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tlas_walk.cuh"

namespace {

using rptr_stream::Ray;
using rptr_stream::kThreads;
using rptr_tlas::Subtrees;

// One lane's walk (kOrdered: nearest subtree first); writes its result at
// ``o`` when it holds a ray (``i < n``). Every lane of the warp must call it.
template <bool kAnyHit, bool kOrdered, class Tiles>
__device__ __forceinline__ void walk_lane(
    const float4* top, int num_top, const Subtrees& scene, const Tiles& tiles,
    const Ray& r, bool has_ray, int o, float* __restrict__ out_t,
    int* __restrict__ out_row, float* __restrict__ out_u,
    float* __restrict__ out_v, unsigned char* __restrict__ out_blocked) {
  rptr_tlas::Walk<kAnyHit, kOrdered, false, Subtrees> w(
      top, num_top, r, has_ray && r.tmax > r.tmin);
  w.run(scene, tiles);
  if (!has_ray) return;
  if (kAnyHit) {
    out_blocked[o] = w.b.blocked ? 1 : 0;
  } else {
    out_t[o] = w.b.row < 0 ? rptr_stream::kTMax : w.b.t;
    out_row[o] = w.b.row;
    out_u[o] = w.b.u;
    out_v[o] = w.b.v;
  }
}

// kMode: 0 every block closest, 1 every block any-hit, 2 blocks from
// shadow_from on any-hit (the merged launch), 3 every block closest in the
// ordered walk. The mode is uniform per block, so per warp.
template <int kMode, class Tiles>
__global__ void __launch_bounds__(kThreads, 4) traverse_streamed_kernel(
    const float* __restrict__ top_g, int num_top,
    const float* __restrict__ sub_nodes, Tiles tiles, int node_rows,
    int sub_leaves, const float* __restrict__ rays, int n, int shadow_from,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  extern __shared__ float4 top[];
  rptr_tlas::stage_top(top, reinterpret_cast<const float4*>(top_g), num_top);
  // every lane stays to the end: the warp tests the leaves together
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r{};
  if (i < n) r.load(rays, n, i);
  const Subtrees scene{reinterpret_cast<const float4*>(sub_nodes),
                       node_rows * 16, sub_leaves};
  if (kMode == 3) {
    walk_lane<false, true>(top, num_top, scene, tiles, r, i < n, i, out_t,
                           out_row, out_u, out_v, out_blocked);
  } else if (kMode == 1 ||
             (kMode == 2 && static_cast<int>(blockIdx.x) >= shadow_from)) {
    walk_lane<true, false>(top, num_top, scene, tiles, r, i < n,
                           i - shadow_from * kThreads, out_t, out_row, out_u,
                           out_v, out_blocked);
  } else {
    walk_lane<false, false>(top, num_top, scene, tiles, r, i < n, i, out_t,
                            out_row, out_u, out_v, out_blocked);
  }
}

template <int kMode, class Tiles>
int launch(const float* top, int num_top, const float* sub_nodes,
           const Tiles& tiles, int node_rows, int sub_leaves,
           const float* rays, int n, int shadow_from, float* out_t,
           int* out_row, float* out_u, float* out_v,
           unsigned char* out_blocked, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 8 * static_cast<size_t>(num_top);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traverse_streamed_kernel<kMode, Tiles>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + kThreads - 1) / kThreads;
  traverse_streamed_kernel<kMode, Tiles><<<grid, kThreads, smem, stream>>>(
      top, num_top, sub_nodes, tiles, node_rows, sub_leaves, rays, n,
      shadow_from, out_t, out_row, out_u, out_v, out_blocked);
  return static_cast<int>(cudaGetLastError());
}

template <class Tiles>
int dispatch(const float* top, int num_top, const float* sub_nodes,
             const Tiles& tiles, int node_rows, int sub_leaves,
             const float* rays, int n, int shadow_from, int ordered,
             float* out_t, int* out_row, float* out_u, float* out_v,
             unsigned char* out_blocked, cudaStream_t s) {
  const int grid = (n + kThreads - 1) / kThreads;
  if (ordered) {
    if (shadow_from < grid) return cudaErrorInvalidValue;
    return launch<3>(top, num_top, sub_nodes, tiles, node_rows, sub_leaves,
                     rays, n, grid, out_t, out_row, out_u, out_v,
                     out_blocked, s);
  }
  if (shadow_from >= grid) {
    return launch<0>(top, num_top, sub_nodes, tiles, node_rows, sub_leaves,
                     rays, n, grid, out_t, out_row, out_u, out_v,
                     out_blocked, s);
  }
  if (shadow_from == 0) {
    return launch<1>(top, num_top, sub_nodes, tiles, node_rows, sub_leaves,
                     rays, n, 0, out_t, out_row, out_u, out_v, out_blocked,
                     s);
  }
  return launch<2>(top, num_top, sub_nodes, tiles, node_rows, sub_leaves,
                   rays, n, shadow_from, out_t, out_row, out_u, out_v,
                   out_blocked, s);
}

}  // namespace

// Plain C entry for ctypes. Blocks of kThreads (128) rays; blocks from
// ``shadow_from`` on run the any-hit mode and write ``blocked`` (n -
// shadow_from * 128 flags), the blocks before it t, row, u, v (their lanes'
// worth): a closest launch is shadow_from >= the grid, an any-hit launch 0.
// ``quantized``: ``tiles`` holds int16 codes (else f32); ``ordered``: the
// ordered walk, closest launches only. ``top``, ``sub_nodes`` and f32
// ``tiles`` must be 16-byte aligned, int16 ``tiles`` 8-byte aligned.
// Launches on ``stream`` and returns cudaGetLastError() (0 = launched). The
// caller allocates every output.
extern "C" int rptr_traverse_streamed(
    const float* top, int num_top, const float* sub_nodes, const void* tiles,
    int node_rows, int sub_leaves, const float* rays, int n, int shadow_from,
    int quantized, int ordered, float* out_t, int* out_row, float* out_u,
    float* out_v, unsigned char* out_blocked, void* stream) {
  if (n <= 0) return 0;
  if (shadow_from < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    const rptr_tlas::QuantTiles q{static_cast<const int16_t*>(tiles),
                                  sub_nodes, sub_leaves * 16,
                                  node_rows * 16};
    return dispatch(top, num_top, sub_nodes, q, node_rows, sub_leaves, rays,
                    n, shadow_from, ordered, out_t, out_row, out_u, out_v,
                    out_blocked, s);
  }
  const rptr_tlas::FieldTiles f{static_cast<const float*>(tiles)};
  return dispatch(top, num_top, sub_nodes, f, node_rows, sub_leaves, rays, n,
                  shadow_from, ordered, out_t, out_row, out_u, out_v,
                  out_blocked, s);
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
