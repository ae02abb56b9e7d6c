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
// world t; walk the chunk's subtree (stream_walk.cuh::walk_subtree, the
// node block of node_rows * 16 slots, local links, SUB_EXIT) with the
// segment [tmin, t_best]. Rows are entry * chunk_tris + leaf * 128 + k, so
// one int32 names the entry (the instance) and the chunk row. The first
// visited triangle keeps an exact-t tie. Closest mode writes t, row, u, v
// (a miss: t = 2e32, row = -1, u = v = 0); any-hit mode stops at the first
// hit and writes blocked = 1.
//
// Design: one thread per ray, each running its own stackless walks. The
// top tree (about 2 nodes x 32 B per entry: 38 KB for the bench's 601
// entries, 160 KB at 2,501) is staged in shared memory by each block (opted
// into more than 48 KB when a scene needs it); the entry table, the chunk
// node blocks and the leaf tiles are read from global memory through the
// read-only path. A top tree past the card's opt-in shared memory per block
// takes the global mode instead: every thread reads the top-tree nodes from
// global memory through the read-only path (two 16-byte loads per node),
// served by L1 and L2. The launcher picks the mode by size, never on a
// failure; the reference's cap of 2,048 entries (its SMEM entry table) does
// not apply. Rows must fit int32: the wrapper checks entries * chunk_tris.
// The TPU kernel's per-block packet bounds, its interval slab test scaled
// by sigma_min, the 16-leaf SMEM flush list and the per-entry DMA of node
// and tile blocks into SMEM/VMEM are TPU devices and are not carried over:
// per-ray results do not depend on them.
//
// What bounds it on this card: divergent, dependent loads of node boxes and
// field-major tile rows, and the Moller-Trumbore work of every entered leaf
// (128 triangles per leaf visit, ~54 flops each), not device-memory
// bandwidth: each unique chunk is stored once (a few hundred KB for the
// bench's instanced field), so the instances' leaves hit L1/L2. The design
// does nothing more about it yet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py), no fast math, so results compare
// bitwise with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_walk.cuh"

namespace {

using rptr_stream::Best;
using rptr_stream::Ray;
using rptr_stream::kLeaf;
using rptr_stream::kThreads;
using rptr_stream::object_ray;

template <bool kAnyHit, bool kGlobal>
__global__ void __launch_bounds__(kThreads) traverse_tlas_stream_kernel(
    const float* __restrict__ top_g, int num_top,
    const float* __restrict__ entry_table,
    const float* __restrict__ sub_nodes, const float* __restrict__ tiles,
    int node_rows, int sub_leaves, const float* __restrict__ rays, int n,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  extern __shared__ float staged[];
  if (!kGlobal) {
    for (int j = threadIdx.x; j < 8 * num_top; j += blockDim.x) {
      staged[j] = __ldg(top_g + j);
    }
    __syncthreads();
  }
  const float* top = kGlobal ? top_g : staged;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Ray r;
  r.load(rays, n, i);
  Best b{r.tmax, -1, 0.0f, 0.0f, false};
  const int slots = node_rows * 16;
  const int chunk_tris = sub_leaves * kLeaf;

  // an empty segment (tmax <= tmin) can never hit: it walks nothing
  int cur = r.tmax > r.tmin ? 0 : num_top;
  while (cur < num_top) {
    float nd[8];
    rptr_stream::load_node<kGlobal>(top + 8 * cur, nd);
    const bool hit_box = rptr_stream::slab(nd, r, b.t);
    const int skip = static_cast<int>(nd[6]);
    const int eid = static_cast<int>(nd[7]);
    if (hit_box && eid >= 0) {
      const float* row = entry_table + static_cast<size_t>(eid) * 16;
      const Ray o = object_ray(row, r);
      const int node_base = static_cast<int>(__ldg(row + 13));
      const int tile_base = static_cast<int>(__ldg(row + 14));
      rptr_stream::walk_subtree<kAnyHit>(
          sub_nodes + static_cast<size_t>(node_base) * 128, slots,
          tiles + static_cast<size_t>(tile_base) * 128, eid * chunk_tris, o,
          b, rptr_stream::Dequant{});
      if (kAnyHit && b.blocked) break;
    }
    cur = (hit_box && eid < 0) ? cur + 1 : skip;
  }

  if (kAnyHit) {
    out_blocked[i] = b.blocked ? 1 : 0;
  } else {
    out_t[i] = b.row < 0 ? rptr_stream::kTMax : b.t;
    out_row[i] = b.row;
    out_u[i] = b.u;
    out_v[i] = b.v;
  }
}

template <bool kAnyHit, bool kGlobal>
int launch(const float* top, int num_top, const float* entry_table,
           const float* sub_nodes, const float* tiles, int node_rows,
           int sub_leaves, const float* rays, int n, float* out_t,
           int* out_row, float* out_u, float* out_v,
           unsigned char* out_blocked, cudaStream_t stream) {
  const size_t smem =
      kGlobal ? 0 : sizeof(float) * 8 * static_cast<size_t>(num_top);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traverse_tlas_stream_kernel<kAnyHit, kGlobal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + kThreads - 1) / kThreads;
  traverse_tlas_stream_kernel<kAnyHit, kGlobal>
      <<<grid, kThreads, smem, stream>>>(
      top, num_top, entry_table, sub_nodes, tiles, node_rows, sub_leaves,
      rays, n, out_t, out_row, out_u, out_v, out_blocked);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched). The caller allocates every output;
// any_hit != 0 writes only ``blocked``, otherwise only t, row, u, v.
// ``global_top`` != 0 reads the top tree from global memory, else each
// block stages it in shared memory.
extern "C" int rptr_traverse_tlas_stream(
    const float* top, int num_top, const float* entry_table,
    const float* sub_nodes, const float* tiles, int node_rows,
    int sub_leaves, const float* rays, int n, int any_hit, int global_top,
    float* out_t, int* out_row, float* out_u, float* out_v,
    unsigned char* out_blocked, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPTR_K7_LAUNCH(A, G)                                                 \
  launch<A, G>(top, num_top, entry_table, sub_nodes, tiles, node_rows,      \
               sub_leaves, rays, n, out_t, out_row, out_u, out_v,           \
               out_blocked, s)
  if (any_hit) {
    return global_top ? RPTR_K7_LAUNCH(true, true)
                      : RPTR_K7_LAUNCH(true, false);
  }
  return global_top ? RPTR_K7_LAUNCH(false, true)
                    : RPTR_K7_LAUNCH(false, false);
#undef RPTR_K7_LAUNCH
}

// The card's opt-in shared memory per block, in bytes (the launcher's
// limit for a staged top tree), or -1 when it cannot be read.
extern "C" int rptr_max_smem_optin(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
