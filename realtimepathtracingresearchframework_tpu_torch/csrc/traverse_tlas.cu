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
// world t; walk the instance's BLAS (its node_count nodes: the last skip
// equals node_count, so the walk leaves there) with the segment [tmin,
// t_best]; if that found a strictly nearer hit, the instance is the winner
// so far. Rows are global: (tile_base + leaf) * 128 + k. The first visited
// triangle keeps an exact-t tie. Closest mode writes t, row, u, v, inst (a
// miss: t = 2e32, row = inst = -1, u = v = 0); any-hit mode stops at the
// first hit and writes blocked = 1.
//
// The ordered mode (closest only) visits a ray's instances nearest first:
// it re-walks the TLAS for the live instance leaf with the least (entry t,
// preorder index) above the last one visited (tlas_walk.cuh::next_ordered)
// and stops when none is entered within the ray's best t; its plain version
// is traverse_tlas.plain_ordered. Results equal the preorder walk's except
// on exact-t ties across instances.
//
// What bounds it on this card: not device-memory bandwidth (the unique
// meshes' tiles, tens of KB for the bench's instanced field, stay in L1/L2)
// but the Moller-Trumbore work of every entered leaf (128 triangles, ~54
// flops each) and how much of the warp does it. A design with one thread
// per ray testing its leaves alone (this kernel's first form) left the rest
// of the warp idle through a leaf's 128 triangles whenever its lanes sat in
// different leaves, as on bounce and shadow queues, with 9 scalar loads per
// triangle touching up to 32 cache lines each; its lanes waited on each
// other between the nested TLAS and BLAS loops; and every block staged the
// whole TLAS with 128 threads.
//
// Design (tlas_walk.cuh): each lane's walk is resumable state, stepped to
// its next entered leaf; the warp then tests every lane's pending leaf in
// turn, 4 triangles a lane from 16-byte coalesced tile loads, and reduces
// to the first least hit, which equals the plain walk bit for bit
// (tlas_walk.cuh gives the argument). Node loads are 16 bytes. The TLAS is
// staged in shared memory by each block or read from global memory through
// the read-only path (``global_top``), and the block size is an argument:
// the launcher (ops/traverse_tlas.py) picks both by the TLAS's size against
// a threshold measured on the card. The TPU kernel's per-block packet
// bounds, its interval slab test scaled by sigma_min, the 16-leaf SMEM
// flush list and the ordered mode's per-packet candidate list are TPU
// devices and are not carried over: per-ray results do not depend on them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py), no fast math, so results compare
// bitwise with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tlas_walk.cuh"

namespace {

using rptr_stream::Ray;
using rptr_stream::kLeaf;
using rptr_tlas::kMaxThreads;
using rptr_tlas::Sub;

// Enters instance iid: its object ray, BLAS nodes, tiles and rows
struct Instances {
  const float* inst_table;
  const float* blas;

  __device__ __forceinline__ Sub enter(int iid, const Ray& r) const {
    const float* row = inst_table + static_cast<size_t>(iid) * 16;
    Sub s;
    s.o = rptr_stream::object_ray(row, r);
    const int node_start = static_cast<int>(__ldg(row + 13));
    const int tile_base = static_cast<int>(__ldg(row + 15));
    s.nodes = reinterpret_cast<const float4*>(
        blas + static_cast<size_t>(node_start) * 8);
    s.count = static_cast<int>(__ldg(row + 14));
    s.tile0 = tile_base * 16;
    s.row0 = tile_base * kLeaf;
    s.id = iid;
    return s;
  }
};

template <bool kAnyHit, bool kOrdered, bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads) traverse_tlas_kernel(
    const float* __restrict__ tlas_g, int num_tlas,
    const float* __restrict__ blas, const float* __restrict__ inst_table,
    const float* __restrict__ tiles, const float* __restrict__ rays, int n,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_inst, unsigned char* __restrict__ out_blocked) {
  extern __shared__ float4 staged[];
  const float4* top = reinterpret_cast<const float4*>(tlas_g);
  if (!kGlobal) {
    rptr_tlas::stage_top(staged, top, num_tlas);
    top = staged;
  }
  // every lane stays to the end: the warp tests the leaves together
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r{};
  if (i < n) r.load(rays, n, i);
  rptr_tlas::Walk<kAnyHit, kOrdered, kGlobal, Instances> w(
      top, num_tlas, r, i < n && r.tmax > r.tmin);
  w.run(Instances{inst_table, blas}, rptr_tlas::FieldTiles{tiles});
  if (i >= n) return;
  if (kAnyHit) {
    out_blocked[i] = w.b.blocked ? 1 : 0;
  } else {
    out_t[i] = w.b.row < 0 ? rptr_stream::kTMax : w.b.t;
    out_row[i] = w.b.row;
    out_u[i] = w.b.u;
    out_v[i] = w.b.v;
    out_inst[i] = w.winner;
  }
}

template <bool kAnyHit, bool kOrdered, bool kGlobal>
int launch(const float* tlas, int num_tlas, const float* blas,
           const float* inst_table, const float* tiles, const float* rays,
           int n, int threads, float* out_t, int* out_row, float* out_u,
           float* out_v, int* out_inst, unsigned char* out_blocked,
           cudaStream_t stream) {
  const size_t smem =
      kGlobal ? 0 : sizeof(float) * 8 * static_cast<size_t>(num_tlas);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traverse_tlas_kernel<kAnyHit, kOrdered, kGlobal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + threads - 1) / threads;
  traverse_tlas_kernel<kAnyHit, kOrdered, kGlobal>
      <<<grid, threads, smem, stream>>>(tlas, num_tlas, blas, inst_table,
                                        tiles, rays, n, out_t, out_row, out_u,
                                        out_v, out_inst, out_blocked);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGlobal>
int launch_mode(const float* tlas, int num_tlas, const float* blas,
                const float* inst_table, const float* tiles, const float* rays,
                int n, int any_hit, int ordered, int threads, float* out_t,
                int* out_row, float* out_u, float* out_v, int* out_inst,
                unsigned char* out_blocked, cudaStream_t s) {
#define RPTR_K6_LAUNCH(A, O)                                                  \
  launch<A, O, kGlobal>(tlas, num_tlas, blas, inst_table, tiles, rays, n,    \
                        threads, out_t, out_row, out_u, out_v, out_inst,     \
                        out_blocked, s)
  if (any_hit) return RPTR_K6_LAUNCH(true, false);
  return ordered ? RPTR_K6_LAUNCH(false, true) : RPTR_K6_LAUNCH(false, false);
#undef RPTR_K6_LAUNCH
}

}  // namespace

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched). The caller allocates every output;
// any_hit != 0 writes only ``blocked``, otherwise only t, row, u, v, inst;
// ``ordered`` (closest only) selects the ordered instance walk;
// ``global_top`` != 0 reads the TLAS from global memory, else each block
// stages it in shared memory; ``threads`` per block: a multiple of 32 up
// to 512. Every float pointer must be 16-byte aligned.
extern "C" int rptr_traverse_tlas(const float* tlas, int num_tlas,
                                  const float* blas, const float* inst_table,
                                  const float* tiles, const float* rays,
                                  int n, int any_hit, int ordered,
                                  int global_top, int threads, float* out_t,
                                  int* out_row, float* out_u, float* out_v,
                                  int* out_inst, unsigned char* out_blocked,
                                  void* stream) {
  if (n <= 0) return 0;
  if ((any_hit && ordered) || threads < 32 || threads > kMaxThreads ||
      threads % 32) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return global_top
             ? launch_mode<true>(tlas, num_tlas, blas, inst_table, tiles, rays,
                                 n, any_hit, ordered, threads, out_t, out_row,
                                 out_u, out_v, out_inst, out_blocked, s)
             : launch_mode<false>(tlas, num_tlas, blas, inst_table, tiles,
                                  rays, n, any_hit, ordered, threads, out_t,
                                  out_row, out_u, out_v, out_inst, out_blocked,
                                  s);
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
