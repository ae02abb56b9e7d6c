// Subtree-binned walk (K5) for Hopper: one bin block against ONE subtree,
// closest hit and any-hit, seeded with the incoming best.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_binned.py::
// _kernel_binned (:218, pallas_call at :422), the kernel of
// occluded_binned, closest_hit_binned and the multislot closest_hit_binned_all,
// on f32 tiles or the 16-bit quantized tiles (quantized=True, :300-350).
// Its plain PyTorch version, which this kernel must equal bit for bit, is
// ops/traverse_binned.py::plain.
//
// What it computes, per lane i of a bin-padded (8, n) operand whose bin
// block (i / block) has subtree sid = sid_blk[i / block]: seed
// t = min(t_in, tmax), row, u, v from the incoming best; if sid >= 0 and
// the lane can still improve (t > tmin, and in any-hit mode not yet
// blocked), walk subtree sid (stream_walk.cuh). Closest mode keeps strictly
// nearer hits; any-hit mode stops at the first hit and marks the lane with
// the subtree's first global row sid * L * 128. It writes t (2e32 where the
// row is -1), row, u, v. Lanes of blocks with sid < 0 (unused bin tails
// and the dead bin) pass their best through.
//
// Design: CUDA blocks of 128 threads, one lane per thread; a bin block is
// a multiple of 128 lanes, so every thread of a CUDA block shares its
// subtree, whose node block (node_rows x 128 f32, 4 KB at 64 leaves) the
// block stages in shared memory, the grid constants of a quantized subtree
// with it (its last slot; stream_walk.cuh::load_tri decodes the codes). Leaf tiles are read from global memory
// (the L2 holds the pack). The TPU kernel's per-block packet bounds and
// cap, its scalar cursor, flush list, and the skip of the tile DMA when the
// previous grid step used the same subtree are TPU devices; per-ray
// results do not depend on them. The row rides an int32 array beside the
// floats, not an int32 bit pattern inside the float operand.
//
// What bounds it on this card: as K4 (traverse_streamed.cu), dependent
// node and tile loads and the Moller-Trumbore work of every entered leaf;
// binning makes a block's rays share one subtree, so the node block is read
// once per block and the warps' tile reads overlap in L1 and L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py), no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_walk.cuh"

namespace {

using rptr_stream::Best;
using rptr_stream::Dequant;
using rptr_stream::Ray;
using rptr_stream::kLeaf;
using rptr_stream::kThreads;

template <bool kAnyHit, typename Tile>
__global__ void __launch_bounds__(kThreads) traverse_binned_kernel(
    const float* __restrict__ sub_nodes, const Tile* __restrict__ tiles,
    int node_rows, int sub_leaves, const int* __restrict__ sid_blk,
    const float* __restrict__ rays, int n, int block,
    const float* __restrict__ in_t, const int* __restrict__ in_row,
    const float* __restrict__ in_u, const float* __restrict__ in_v,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ float nodes[];
  const int slots = node_rows * 16;
  const int sid = sid_blk[(blockIdx.x * blockDim.x) / block];
  if (sid >= 0) {
    const float* src = sub_nodes + static_cast<size_t>(sid) * slots * 8;
    for (int j = threadIdx.x; j < 8 * slots; j += blockDim.x) {
      nodes[j] = __ldg(src + j);
    }
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Ray r;
  r.load(rays, n, i);
  Best b{fminf(in_t[i], r.tmax), in_row[i], in_u[i], in_v[i], false};
  if (sid >= 0 && b.t > r.tmin && !(kAnyHit && b.row >= 0)) {
    const int row0 = sid * sub_leaves * kLeaf;
    const Dequant dq =
        sizeof(Tile) == 2 ? rptr_stream::dequant_of(nodes, slots) : Dequant{};
    rptr_stream::walk_subtree<kAnyHit>(
        nodes, slots,
        tiles + static_cast<size_t>(sid) * sub_leaves * 16 * kLeaf, row0, r,
        b, dq);
    if (kAnyHit && b.blocked) b.row = row0;
  }
  out_t[i] = b.row < 0 ? rptr_stream::kTMax : b.t;
  out_row[i] = b.row;
  out_u[i] = b.u;
  out_v[i] = b.v;
}

template <bool kAnyHit, typename Tile>
int launch(const float* sub_nodes, const void* tiles, int node_rows,
           int sub_leaves, const int* sid_blk, const float* rays, int n,
           int block, const float* in_t, const int* in_row, const float* in_u,
           const float* in_v, float* out_t, int* out_row, float* out_u,
           float* out_v, cudaStream_t s) {
  const int grid = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * 8 * 16 * static_cast<size_t>(node_rows);
  traverse_binned_kernel<kAnyHit, Tile><<<grid, kThreads, smem, s>>>(
      sub_nodes, static_cast<const Tile*>(tiles), node_rows, sub_leaves,
      sid_blk, rays, n, block, in_t, in_row, in_u, in_v, out_t, out_row,
      out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. ``n`` is a multiple of ``block``, and ``block``
// of 128; ``quantized``: ``tiles`` holds int16 codes (else f32). Launches on
// ``stream`` and returns cudaGetLastError() (0 = launched). The caller
// allocates the four outputs.
extern "C" int rptr_traverse_binned(
    const float* sub_nodes, const void* tiles, int node_rows, int sub_leaves,
    const int* sid_blk, const float* rays, int n, int block, int any_hit,
    int quantized, const float* in_t, const int* in_row, const float* in_u,
    const float* in_v, float* out_t, int* out_row, float* out_u,
    float* out_v, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return any_hit
               ? launch<true, int16_t>(sub_nodes, tiles, node_rows,
                                       sub_leaves, sid_blk, rays, n, block,
                                       in_t, in_row, in_u, in_v, out_t,
                                       out_row, out_u, out_v, s)
               : launch<false, int16_t>(sub_nodes, tiles, node_rows,
                                        sub_leaves, sid_blk, rays, n, block,
                                        in_t, in_row, in_u, in_v, out_t,
                                        out_row, out_u, out_v, s);
  }
  return any_hit ? launch<true, float>(sub_nodes, tiles, node_rows,
                                       sub_leaves, sid_blk, rays, n, block,
                                       in_t, in_row, in_u, in_v, out_t,
                                       out_row, out_u, out_v, s)
                 : launch<false, float>(sub_nodes, tiles, node_rows,
                                        sub_leaves, sid_blk, rays, n, block,
                                        in_t, in_row, in_u, in_v, out_t,
                                        out_row, out_u, out_v, s);
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
