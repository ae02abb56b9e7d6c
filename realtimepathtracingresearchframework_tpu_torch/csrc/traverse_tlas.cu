// Resident two-level walk (K6) for Hopper: closest hit and any-hit over a
// TLAS of instances and per-mesh object-space BLASes.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_tlas.py::
// _kernel_tlas (:202, pallas_call at :491), in its preorder mode
// (closest_hit_tlas_pallas, occluded_tlas_pallas) and its ordered instance
// walk (closest_hit_tlas_pallas(ordered=True), :372-431). Its plain PyTorch
// version, which this kernel must equal bit for bit, is
// ops/traverse_tlas.py::plain.
//
// What it computes, per ray: walk the TLAS (tlas_nodes: min3, max3, skip,
// instance id or -1, links as float values) in preorder from node 0,
// entering a node when the slab test passes with t_far capped by the ray's
// best hit so far (tmax at the start). At an entered instance leaf, take
// the ray to object space with the instance's inverse affine (inst_table
// row: A^-1 row-major, its translation, sigma_min, node_start, node_count,
// tile_base), WITHOUT renormalising the direction, so object-space t is
// world t; walk the instance's BLAS (stream_walk.cuh::walk_subtree on its
// node_count nodes: the last skip equals node_count, so the walk leaves
// there) with the segment [tmin, t_best]; if that found a strictly nearer
// hit, the instance is the winner so far. Rows are global: (tile_base +
// leaf) * 128 + k. The first visited triangle keeps an exact-t tie. Closest
// mode writes t, row, u, v, inst (a miss: t = 2e32, row = inst = -1,
// u = v = 0); any-hit mode stops at the first hit and writes blocked = 1.
//
// The ordered mode (closest only) visits a ray's instances nearest first:
// it re-walks the TLAS for the live instance leaf with the least (entry t,
// preorder index) above the last one visited (stream_walk.cuh::
// next_ordered) and stops when none is entered within the ray's best t; its
// plain version is traverse_tlas.plain_ordered. Results equal the preorder
// walk's except on exact-t ties across instances.
//
// Design: one thread per ray, each running its own stackless walks. The
// TLAS (about 2 nodes x 32 B per instance: 32 KB at 512 instances) is
// staged in shared memory by each block; the instance table, the BLAS
// nodes and the leaf tiles are read from global memory through the
// read-only path. The TPU kernel's per-block packet bounds, its interval
// slab test scaled by sigma_min, the 16-leaf SMEM flush list and the
// ordered mode's per-packet candidate list are TPU devices and are not
// carried over: per-ray results do not depend on them.
//
// What bounds it on this card: divergent, dependent loads of node boxes and
// field-major tile rows, and the Moller-Trumbore work of every entered leaf
// (128 triangles per leaf visit, ~54 flops each), not device-memory
// bandwidth: the unique meshes' tiles (tens of KB for the bench's instanced
// field) stay in L1/L2. The design does nothing more about it yet.
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
using rptr_stream::object_ray;

template <bool kAnyHit, bool kOrdered>
__global__ void __launch_bounds__(kThreads) traverse_tlas_kernel(
    const float* __restrict__ tlas_g, int num_tlas,
    const float* __restrict__ blas, const float* __restrict__ inst_table,
    const float* __restrict__ tiles, const float* __restrict__ rays, int n,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_inst, unsigned char* __restrict__ out_blocked) {
  extern __shared__ float top[];
  for (int j = threadIdx.x; j < 8 * num_tlas; j += blockDim.x) {
    top[j] = __ldg(tlas_g + j);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Ray r;
  r.load(rays, n, i);
  Best b{r.tmax, -1, 0.0f, 0.0f, false};
  int inst = -1;

  // the walk of instance iid's BLAS in object space; a strictly nearer hit
  // makes it the winner so far
  auto visit = [&](int iid) {
    const float* row = inst_table + static_cast<size_t>(iid) * 16;
    const Ray o = object_ray(row, r);
    const int node_start = static_cast<int>(__ldg(row + 13));
    const int node_count = static_cast<int>(__ldg(row + 14));
    const int tile_base = static_cast<int>(__ldg(row + 15));
    const float old_t = b.t;
    rptr_stream::walk_subtree<kAnyHit>(
        blas + static_cast<size_t>(node_start) * 8, node_count,
        tiles + static_cast<size_t>(tile_base) * 16 * kLeaf,
        tile_base * kLeaf, o, b, Dequant{});
    if (b.t < old_t) inst = iid;
  };

  // an empty segment (tmax <= tmin) can never hit: it walks nothing
  if (kOrdered) {
    float last_e = -INFINITY;
    int last_j = -1;
    while (r.tmax > r.tmin) {
      float e;
      const int j = rptr_stream::next_ordered<false>(top, num_tlas, r, b.t,
                                                     last_e, last_j, e);
      if (j < 0) break;
      visit(static_cast<int>(top[8 * j + 7]));
      last_e = e;
      last_j = j;
    }
  } else {
    int cur = r.tmax > r.tmin ? 0 : num_tlas;
    while (cur < num_tlas) {
      const float* nd = top + 8 * cur;
      const bool hit_box = rptr_stream::slab(nd, r, b.t);
      const int skip = static_cast<int>(nd[6]);
      const int iid = static_cast<int>(nd[7]);
      if (hit_box && iid >= 0) {
        visit(iid);
        if (kAnyHit && b.blocked) break;
      }
      cur = (hit_box && iid < 0) ? cur + 1 : skip;
    }
  }

  if (kAnyHit) {
    out_blocked[i] = b.blocked ? 1 : 0;
  } else {
    out_t[i] = b.row < 0 ? rptr_stream::kTMax : b.t;
    out_row[i] = b.row;
    out_u[i] = b.u;
    out_v[i] = b.v;
    out_inst[i] = inst;
  }
}

template <bool kAnyHit, bool kOrdered>
int launch(const float* tlas, int num_tlas, const float* blas,
           const float* inst_table, const float* tiles, const float* rays,
           int n, float* out_t, int* out_row, float* out_u, float* out_v,
           int* out_inst, unsigned char* out_blocked, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 8 * static_cast<size_t>(num_tlas);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traverse_tlas_kernel<kAnyHit, kOrdered>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + kThreads - 1) / kThreads;
  traverse_tlas_kernel<kAnyHit, kOrdered><<<grid, kThreads, smem, stream>>>(
      tlas, num_tlas, blas, inst_table, tiles, rays, n, out_t, out_row, out_u,
      out_v, out_inst, out_blocked);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched). The caller allocates every output;
// any_hit != 0 writes only ``blocked``, otherwise only t, row, u, v, inst;
// ``ordered`` (closest only) selects the ordered instance walk.
extern "C" int rptr_traverse_tlas(const float* tlas, int num_tlas,
                                  const float* blas, const float* inst_table,
                                  const float* tiles, const float* rays,
                                  int n, int any_hit, int ordered,
                                  float* out_t, int* out_row, float* out_u,
                                  float* out_v, int* out_inst,
                                  unsigned char* out_blocked, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    if (ordered) return cudaErrorInvalidValue;
    return launch<true, false>(tlas, num_tlas, blas, inst_table, tiles, rays,
                               n, out_t, out_row, out_u, out_v, out_inst,
                               out_blocked, s);
  }
  if (ordered) {
    return launch<false, true>(tlas, num_tlas, blas, inst_table, tiles, rays,
                               n, out_t, out_row, out_u, out_v, out_inst,
                               out_blocked, s);
  }
  return launch<false, false>(tlas, num_tlas, blas, inst_table, tiles, rays,
                              n, out_t, out_row, out_u, out_v, out_inst,
                              out_blocked, s);
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
