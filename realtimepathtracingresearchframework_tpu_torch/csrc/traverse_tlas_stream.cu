// Streamed two-level walk (K7) for Hopper: closest hit and any-hit over a
// top tree of (instance, chunk) entries and per-mesh object-space chunk
// subtrees.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_tlas_stream.py::
// _kernel_tlas_stream (:276, pallas_call at :517) (closest_hit_tlas_stream,
// occluded_tlas_stream). Its plain PyTorch version, which this kernel must
// equal bit for bit, is ops/traverse_tlas_stream.py::plain.
//
// What it computes, per ray: walk the top tree (min3, max3, skip, entry id
// or -1, links as float values) in preorder from node 0, entering a node
// when the slab test passes with t_far capped by the ray's best hit so far
// (tmax at the start). At an entered entry, take the ray to object space
// with the entry's inverse affine (entry_table row: A^-1 row-major, its
// translation, sigma_min, the chunk's first sub_nodes row, its first
// tri_tiles row), WITHOUT renormalising the direction, so object-space t is
// world t; walk the chunk's subtree (the node block of node_rows * 16
// slots, local links, SUB_EXIT) with the segment [tmin, t_best]. Rows are
// entry * chunk_tris + leaf * 128 + k, so one int32 names the entry (the
// instance) and the chunk row. The first visited triangle keeps an exact-t
// tie. Closest mode writes t, row, u, v (a miss: t = 2e32, row = -1,
// u = v = 0); any-hit mode stops at the first hit and writes blocked = 1.
//
// What bounds it on this card: not device-memory bandwidth (each unique
// chunk is stored once, a few hundred KB for the bench's instanced field,
// so the instances' leaves hit L1/L2) but the Moller-Trumbore work of every
// entered leaf (128 triangles, ~54 flops each) and how much of the warp
// does it, and, with a large top tree, the blocks an SM can hold. A design
// with one thread per ray testing its leaves alone (this kernel's first
// form) left the rest of the warp idle through a leaf's 128 triangles
// whenever its lanes sat in different leaves, with 9 scalar loads per
// triangle touching up to 32 cache lines each; its lanes waited on each
// other between the nested top-tree and chunk loops; and a block of 128
// threads staged the whole top tree (160 KB at 2,501 entries: one block,
// 4 warps, per SM).
//
// Design (tlas_walk.cuh): each lane's walk is resumable state, stepped to
// its next entered leaf; the warp then tests every lane's pending leaf in
// turn, 4 triangles a lane from 16-byte coalesced tile loads, and reduces
// to the first least hit, which equals the plain walk bit for bit
// (tlas_walk.cuh gives the argument). Node loads are 16 bytes. The top
// tree is staged in shared memory by each block or read from global memory
// through the read-only path (``global_top``), and the block size is an
// argument: the launcher (ops/traverse_tlas_stream.py) picks both by the
// top tree's size against a threshold measured on the card, never on a
// failure; the reference's cap of 2,048 entries (its SMEM entry table)
// does not apply. Rows must fit int32: the wrapper checks entries *
// chunk_tris. The TPU kernel's per-block packet bounds, its interval slab
// test scaled by sigma_min, the 16-leaf SMEM flush list and the per-entry
// DMA of node and tile blocks into SMEM/VMEM are TPU devices and are not
// carried over: per-ray results do not depend on them.
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

// Enters entry eid: its object ray, the chunk's node block, tiles and rows
struct Chunks {
  const float* entry_table;
  const float* sub_nodes;
  int slots, chunk_tris;

  __device__ __forceinline__ Sub enter(int eid, const Ray& r) const {
    const float* row = entry_table + static_cast<size_t>(eid) * 16;
    Sub s;
    s.o = rptr_stream::object_ray(row, r);
    const int node_base = static_cast<int>(__ldg(row + 13));
    s.nodes = reinterpret_cast<const float4*>(
        sub_nodes + static_cast<size_t>(node_base) * 128);
    s.count = slots;
    s.tile0 = static_cast<int>(__ldg(row + 14));
    s.row0 = eid * chunk_tris;
    s.id = eid;
    return s;
  }
};

template <bool kAnyHit, bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads) traverse_tlas_stream_kernel(
    const float* __restrict__ top_g, int num_top,
    const float* __restrict__ entry_table,
    const float* __restrict__ sub_nodes, const float* __restrict__ tiles,
    int node_rows, int sub_leaves, const float* __restrict__ rays, int n,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  extern __shared__ float4 staged[];
  const float4* top = reinterpret_cast<const float4*>(top_g);
  if (!kGlobal) {
    rptr_tlas::stage_top(staged, top, num_top);
    top = staged;
  }
  // every lane stays to the end: the warp tests the leaves together
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r{};
  if (i < n) r.load(rays, n, i);
  rptr_tlas::Walk<kAnyHit, false, kGlobal, Chunks> w(
      top, num_top, r, i < n && r.tmax > r.tmin);
  w.run(Chunks{entry_table, sub_nodes, node_rows * 16, sub_leaves * kLeaf},
        rptr_tlas::FieldTiles{tiles});
  if (i >= n) return;
  if (kAnyHit) {
    out_blocked[i] = w.b.blocked ? 1 : 0;
  } else {
    out_t[i] = w.b.row < 0 ? rptr_stream::kTMax : w.b.t;
    out_row[i] = w.b.row;
    out_u[i] = w.b.u;
    out_v[i] = w.b.v;
  }
}

template <bool kAnyHit, bool kGlobal>
int launch(const float* top, int num_top, const float* entry_table,
           const float* sub_nodes, const float* tiles, int node_rows,
           int sub_leaves, const float* rays, int n, int threads,
           float* out_t, int* out_row, float* out_u, float* out_v,
           unsigned char* out_blocked, cudaStream_t stream) {
  const size_t smem =
      kGlobal ? 0 : sizeof(float) * 8 * static_cast<size_t>(num_top);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traverse_tlas_stream_kernel<kAnyHit, kGlobal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + threads - 1) / threads;
  traverse_tlas_stream_kernel<kAnyHit, kGlobal>
      <<<grid, threads, smem, stream>>>(
      top, num_top, entry_table, sub_nodes, tiles, node_rows, sub_leaves,
      rays, n, out_t, out_row, out_u, out_v, out_blocked);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched). The caller allocates every output;
// any_hit != 0 writes only ``blocked``, otherwise only t, row, u, v.
// ``global_top`` != 0 reads the top tree from global memory, else each
// block stages it in shared memory; ``threads`` per block: a multiple of
// 32 up to 512. Every float pointer must be 16-byte aligned.
extern "C" int rptr_traverse_tlas_stream(
    const float* top, int num_top, const float* entry_table,
    const float* sub_nodes, const float* tiles, int node_rows,
    int sub_leaves, const float* rays, int n, int any_hit, int global_top,
    int threads, float* out_t, int* out_row, float* out_u, float* out_v,
    unsigned char* out_blocked, void* stream) {
  if (n <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPTR_K7_LAUNCH(A, G)                                                 \
  launch<A, G>(top, num_top, entry_table, sub_nodes, tiles, node_rows,      \
               sub_leaves, rays, n, threads, out_t, out_row, out_u, out_v,  \
               out_blocked, s)
  if (any_hit) {
    return global_top ? RPTR_K7_LAUNCH(true, true)
                      : RPTR_K7_LAUNCH(true, false);
  }
  return global_top ? RPTR_K7_LAUNCH(false, true)
                    : RPTR_K7_LAUNCH(false, false);
#undef RPTR_K7_LAUNCH
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
