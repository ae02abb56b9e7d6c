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
// leaf (payload = subtree id) walk that subtree (stream_walk.cuh) and go on
// at the leaf's skip link. Hits improve strictly, so the first visited
// triangle keeps an exact-t tie. Closest mode writes t, global row, u, v (a
// miss: t = 2e32, row = -1, u = v = 0); any-hit mode stops at the first hit
// and writes blocked = 1. The mode is per block: blocks from
// ``shadow_from`` on take the any-hit exit, so one launch can carry a
// closest queue in its first blocks and a shadow queue after it (the merged
// mode, traverse_stream.closest_and_occluded_streamed :967); any-hit lane i
// writes blocked[i - shadow_from * kThreads].
//
// The ordered mode (closest only) visits a ray's subtrees nearest first
// instead: it re-walks the top tree for the live top leaf with the least
// (entry t, preorder index) above the last one visited
// (stream_walk.cuh::next_ordered) and stops when none is entered within the
// ray's best t. Its results equal the preorder walk's except on exact-t ties
// across subtrees; its plain version is traverse_stream.plain_ordered. On a
// quantized pack the leaf loop decodes the int16 codes with the subtree's
// grid constants (stream_walk.cuh::load_tri).
//
// Design: one thread per ray, each running its own stackless walks. The
// top tree (Mt nodes x 32 B: 4 KB at 64 subtrees) is staged in shared
// memory by each block; subtree nodes and leaf tiles are read from global
// memory through the read-only path. The TPU kernel's per-block packet
// bounds, scalar cursor, 16-leaf SMEM flush list, whole-subtree tile DMA
// into VMEM and its per-packet candidate list are TPU devices and are not
// carried over; per-ray results do not depend on them.
//
// What bounds it on this card: divergent, dependent loads of node boxes and
// tile fields, and the Moller-Trumbore work of every entered leaf (128
// triangles per leaf visit, ~54 flops each), not device-memory bandwidth:
// the 500k-triangle pack (32.5 MB of tiles) stays in the 50 MB L2. The
// design does nothing more about it yet; later work can stage an entered
// leaf's tile in shared memory per warp, sort rays for coherence (the
// renderer already does), or test leaf boxes before the triangles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py), no fast math, so results compare
// bitwise with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_walk.cuh"

namespace {

using rptr_stream::Best;
using rptr_stream::Dequant;
using rptr_stream::Ray;
using rptr_stream::kLeaf;
using rptr_stream::kThreads;

// One ray's walk from top node 0 (kOrdered: nearest subtree first); writes
// its result at ``o``.
template <bool kAnyHit, bool kOrdered, typename Tile>
__device__ __forceinline__ void walk_ray(
    const float* top, int num_top, const float* __restrict__ sub_nodes,
    const Tile* __restrict__ tiles, int node_rows, int sub_leaves,
    const float* __restrict__ rays, int n, int i, int o,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  Ray r;
  r.load(rays, n, i);
  Best b{r.tmax, -1, 0.0f, 0.0f, false};
  const int slots = node_rows * 16;
  const size_t sub_floats = static_cast<size_t>(slots) * 8;
  const size_t tile_elems = static_cast<size_t>(sub_leaves) * 16 * kLeaf;
  const bool quantized = sizeof(Tile) == 2;

  auto visit = [&](int sid) {
    const float* nodes = sub_nodes + sid * sub_floats;
    const Dequant dq =
        quantized ? rptr_stream::dequant_of(nodes, slots) : Dequant{};
    rptr_stream::walk_subtree<kAnyHit>(nodes, slots, tiles + sid * tile_elems,
                                       sid * sub_leaves * kLeaf, r, b, dq);
  };

  // an empty segment (tmax <= tmin) can never hit: it walks nothing
  if (kOrdered) {
    float last_e = -INFINITY;
    int last_j = -1;
    while (r.tmax > r.tmin) {
      float e;
      const int j = rptr_stream::next_ordered<false>(top, num_top, r, b.t,
                                                     last_e, last_j, e);
      if (j < 0) break;
      visit(static_cast<int>(top[8 * j + 7]));
      last_e = e;
      last_j = j;
    }
  } else {
    int cur = r.tmax > r.tmin ? 0 : num_top;
    while (cur < num_top) {
      const float* nd = top + 8 * cur;
      const bool hit_box = rptr_stream::slab(nd, r, b.t);
      const int skip = static_cast<int>(nd[6]);
      const int sid = static_cast<int>(nd[7]);
      if (hit_box && sid >= 0) {
        visit(sid);
        if (kAnyHit && b.blocked) break;
      }
      cur = (hit_box && sid < 0) ? cur + 1 : skip;
    }
  }

  if (kAnyHit) {
    out_blocked[o] = b.blocked ? 1 : 0;
  } else {
    out_t[o] = b.row < 0 ? rptr_stream::kTMax : b.t;
    out_row[o] = b.row;
    out_u[o] = b.u;
    out_v[o] = b.v;
  }
}

// kMode: 0 every block closest, 1 every block any-hit, 2 blocks from
// shadow_from on any-hit (the merged launch), 3 every block closest in the
// ordered walk
template <int kMode, typename Tile>
__global__ void __launch_bounds__(kThreads) traverse_streamed_kernel(
    const float* __restrict__ top_g, int num_top,
    const float* __restrict__ sub_nodes, const Tile* __restrict__ tiles,
    int node_rows, int sub_leaves, const float* __restrict__ rays, int n,
    int shadow_from, float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  extern __shared__ float top[];
  for (int j = threadIdx.x; j < 8 * num_top; j += blockDim.x) {
    top[j] = __ldg(top_g + j);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (kMode == 3) {
    walk_ray<false, true>(top, num_top, sub_nodes, tiles, node_rows,
                          sub_leaves, rays, n, i, i, out_t, out_row, out_u,
                          out_v, out_blocked);
  } else if (kMode == 1 ||
             (kMode == 2 && static_cast<int>(blockIdx.x) >= shadow_from)) {
    walk_ray<true, false>(top, num_top, sub_nodes, tiles, node_rows,
                          sub_leaves, rays, n, i, i - shadow_from * kThreads,
                          out_t, out_row, out_u, out_v, out_blocked);
  } else {
    walk_ray<false, false>(top, num_top, sub_nodes, tiles, node_rows,
                           sub_leaves, rays, n, i, i, out_t, out_row, out_u,
                           out_v, out_blocked);
  }
}

template <int kMode, typename Tile>
int launch(const float* top, int num_top, const float* sub_nodes,
           const void* tiles, int node_rows, int sub_leaves,
           const float* rays, int n, int shadow_from, float* out_t,
           int* out_row, float* out_u, float* out_v,
           unsigned char* out_blocked, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 8 * static_cast<size_t>(num_top);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traverse_streamed_kernel<kMode, Tile>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + kThreads - 1) / kThreads;
  traverse_streamed_kernel<kMode, Tile><<<grid, kThreads, smem, stream>>>(
      top, num_top, sub_nodes, static_cast<const Tile*>(tiles), node_rows,
      sub_leaves, rays, n, shadow_from, out_t, out_row, out_u, out_v,
      out_blocked);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tile>
int dispatch(const float* top, int num_top, const float* sub_nodes,
             const void* tiles, int node_rows, int sub_leaves,
             const float* rays, int n, int shadow_from, int ordered,
             float* out_t, int* out_row, float* out_u, float* out_v,
             unsigned char* out_blocked, cudaStream_t s) {
  const int grid = (n + kThreads - 1) / kThreads;
  if (ordered) {
    if (shadow_from < grid) return cudaErrorInvalidValue;
    return launch<3, Tile>(top, num_top, sub_nodes, tiles, node_rows,
                           sub_leaves, rays, n, grid, out_t, out_row, out_u,
                           out_v, out_blocked, s);
  }
  if (shadow_from >= grid) {
    return launch<0, Tile>(top, num_top, sub_nodes, tiles, node_rows,
                           sub_leaves, rays, n, grid, out_t, out_row, out_u,
                           out_v, out_blocked, s);
  }
  if (shadow_from == 0) {
    return launch<1, Tile>(top, num_top, sub_nodes, tiles, node_rows,
                           sub_leaves, rays, n, 0, out_t, out_row, out_u,
                           out_v, out_blocked, s);
  }
  return launch<2, Tile>(top, num_top, sub_nodes, tiles, node_rows,
                         sub_leaves, rays, n, shadow_from, out_t, out_row,
                         out_u, out_v, out_blocked, s);
}

}  // namespace

// Plain C entry for ctypes. Blocks of kThreads (128) rays; blocks from
// ``shadow_from`` on run the any-hit mode and write ``blocked`` (n -
// shadow_from * 128 flags), the blocks before it t, row, u, v (their lanes'
// worth): a closest launch is shadow_from >= the grid, an any-hit launch 0.
// ``quantized``: ``tiles`` holds int16 codes (else f32); ``ordered``: the
// ordered walk, closest launches only. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched). The caller allocates every output.
extern "C" int rptr_traverse_streamed(
    const float* top, int num_top, const float* sub_nodes, const void* tiles,
    int node_rows, int sub_leaves, const float* rays, int n, int shadow_from,
    int quantized, int ordered, float* out_t, int* out_row, float* out_u,
    float* out_v, unsigned char* out_blocked, void* stream) {
  if (n <= 0) return 0;
  if (shadow_from < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return dispatch<int16_t>(top, num_top, sub_nodes, tiles, node_rows,
                             sub_leaves, rays, n, shadow_from, ordered, out_t,
                             out_row, out_u, out_v, out_blocked, s);
  }
  return dispatch<float>(top, num_top, sub_nodes, tiles, node_rows,
                         sub_leaves, rays, n, shadow_from, ordered, out_t,
                         out_row, out_u, out_v, out_blocked, s);
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
