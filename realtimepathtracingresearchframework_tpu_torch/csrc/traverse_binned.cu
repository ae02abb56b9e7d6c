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
// blocked), walk subtree sid with the plain threaded walk (slab test capped
// by the best t, Moller-Trumbore of every entered leaf). Closest mode keeps
// strictly nearer hits; any-hit mode stops at the first hit and marks the
// lane with the subtree's first global row sid * L * 128. It writes t (2e32
// where the row is -1), row, u, v. Lanes of blocks with sid < 0 (unused bin
// tails and the dead bin) pass their best through.
//
// What bounds it on this card: the Moller-Trumbore work of the entered
// leaves (128 triangles, ~54 flops each) and how much of the warp does it;
// the 500k-triangle pack stays in the 50 MB L2. This kernel's first form
// ran one thread per lane through its subtree, each lane scanning the 128
// triangles of every leaf it entered alone with 9 scalar loads per
// triangle: binning gives a warp one subtree, not one leaf, so its lanes
// scanned different leaves at 32 addresses and the warp waited for its
// longest walk.
//
// Design: K4's (tlas_walk.cuh), entered at the bin's subtree. Each lane
// walks its subtree as resumable state (rptr_tlas::Walk from its seeded
// best, with no top tree), stepped to its next entered leaf; the warp then
// serves the lanes' pending leaves (serve_leaves): a leaf that ``scan_from``
// or more lanes of the warp hold is scanned by each holder in k order with
// broadcast loads, any other is tested by the whole warp, 4 triangles a lane
// from 9 coalesced loads (FieldTiles, 16 bytes a lane; QuantTiles decodes
// int16 tiles from 8-byte loads with the subtree's grid). Both keep the
// leaf's first least hit, which equals the plain walk bit for bit
// (tlas_walk.cuh gives the argument). A bin block is a multiple of 128
// lanes, so every CUDA block of 128 threads, and every warp, lies in one bin
// block and walks one subtree, whose node block (node_rows x 128 f32, 4 KB
// at 64 leaves) the block stages in shared memory: measured 5-8% faster on
// int16 tiles than reading it from global memory as K4 does, and within 2%
// on f32 tiles (PERF.md). Tiles come from global memory through the
// read-only path. The TPU kernel's per-block packet
// bounds and cap, its scalar cursor, flush list, and the skip of the tile
// DMA when the previous grid step used the same subtree are TPU devices;
// per-ray results do not depend on them. The row rides an int32 array beside
// the floats, not an int32 bit pattern inside the float operand.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py), no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tlas_walk.cuh"

namespace {

using rptr_stream::Best;
using rptr_stream::Ray;
using rptr_stream::kThreads;
using rptr_tlas::Sub;
using rptr_tlas::Subtrees;

template <bool kAnyHit, class Tiles>
__global__ void __launch_bounds__(kThreads, 4) traverse_binned_kernel(
    const float* __restrict__ sub_nodes, Tiles tiles, int node_rows,
    int sub_leaves, const int* __restrict__ sid_blk,
    const float* __restrict__ rays, int n, int block, int scan_from,
    const float* __restrict__ in_t, const int* __restrict__ in_row,
    const float* __restrict__ in_u, const float* __restrict__ in_v,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ float4 staged[];
  const int slots = node_rows * 16;
  // uniform over the block: a bin block is whole CUDA blocks
  const int sid = sid_blk[(blockIdx.x * blockDim.x) / block];
  const Subtrees scene{reinterpret_cast<const float4*>(sub_nodes), slots,
                       sub_leaves};
  if (sid >= 0) {
    rptr_tlas::stage_top(staged, scene.sub_nodes + 2 * slots * sid, slots);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n % 128 == 0
  Ray r;
  r.load(rays, n, i);
  const Best seed{fminf(in_t[i], r.tmax), in_row[i], in_u[i], in_v[i], false};
  const bool live =
      sid >= 0 && seed.t > r.tmin && !(kAnyHit && seed.row >= 0);
  Sub s = scene.enter(sid >= 0 ? sid : 0, r);
  s.nodes = staged;
  // every lane stays to the end: the warp tests the leaves together
  rptr_tlas::Walk<kAnyHit, false, true, Subtrees, false> w(s, seed, live);
  for (;;) {
    const bool pending = w.step(scene);
    const unsigned pend = __ballot_sync(rptr_tlas::kFull, pending);
    if (pend == 0) break;
    rptr_tlas::serve_leaves<kAnyHit>(pending, pend, tiles, r, w.tile_row,
                                     w.leaf_row, scan_from, w.b);
    if (kAnyHit && w.b.blocked) w.done = true;
  }
  Best b = w.b;
  if (kAnyHit && b.blocked) b.row = s.row0;
  out_t[i] = b.row < 0 ? rptr_stream::kTMax : b.t;
  out_row[i] = b.row;
  out_u[i] = b.u;
  out_v[i] = b.v;
}

template <bool kAnyHit, class Tiles>
int launch(const float* sub_nodes, const Tiles& tiles, int node_rows,
           int sub_leaves, const int* sid_blk, const float* rays, int n,
           int block, int scan_from, const float* in_t, const int* in_row,
           const float* in_u, const float* in_v, float* out_t, int* out_row,
           float* out_u, float* out_v, cudaStream_t s) {
  const size_t smem = sizeof(float4) * 2 * 16 * static_cast<size_t>(node_rows);
  traverse_binned_kernel<kAnyHit, Tiles><<<n / kThreads, kThreads, smem, s>>>(
      sub_nodes, tiles, node_rows, sub_leaves, sid_blk, rays, n, block,
      scan_from, in_t, in_row, in_u, in_v, out_t, out_row, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

template <class Tiles>
int dispatch(int any_hit, const float* sub_nodes, const Tiles& tiles,
             int node_rows, int sub_leaves, const int* sid_blk,
             const float* rays, int n, int block, int scan_from,
             const float* in_t, const int* in_row, const float* in_u,
             const float* in_v, float* out_t, int* out_row, float* out_u,
             float* out_v, cudaStream_t s) {
  return any_hit
             ? launch<true>(sub_nodes, tiles, node_rows, sub_leaves, sid_blk,
                            rays, n, block, scan_from, in_t, in_row, in_u,
                            in_v, out_t, out_row, out_u, out_v, s)
             : launch<false>(sub_nodes, tiles, node_rows, sub_leaves, sid_blk,
                             rays, n, block, scan_from, in_t, in_row, in_u,
                             in_v, out_t, out_row, out_u, out_v, s);
}

}  // namespace

// Plain C entry for ctypes. ``n`` is a multiple of ``block``, and ``block``
// of 128; ``quantized``: ``tiles`` holds int16 codes (else f32);
// ``sub_nodes`` and f32 ``tiles`` 16-byte aligned, int16 ``tiles`` 8-byte
// aligned. ``scan_from``: a leaf that this many lanes of a warp hold is
// scanned by each of them alone (> 32: never). Launches on ``stream`` and
// returns cudaGetLastError() (0 = launched). The caller allocates the four
// outputs.
extern "C" int rptr_traverse_binned(
    const float* sub_nodes, const void* tiles, int node_rows, int sub_leaves,
    const int* sid_blk, const float* rays, int n, int block, int any_hit,
    int quantized, const float* in_t, const int* in_row, const float* in_u,
    const float* in_v, float* out_t, int* out_row, float* out_u,
    float* out_v, void* stream, int scan_from) {
  if (n <= 0) return 0;
  if (block <= 0 || block % kThreads || n % block) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    const rptr_tlas::QuantTiles q{static_cast<const int16_t*>(tiles),
                                  sub_nodes, sub_leaves * 16,
                                  node_rows * 16};
    return dispatch(any_hit, sub_nodes, q, node_rows, sub_leaves, sid_blk,
                    rays, n, block, scan_from, in_t, in_row, in_u, in_v, out_t,
                    out_row, out_u, out_v, s);
  }
  const rptr_tlas::FieldTiles f{static_cast<const float*>(tiles)};
  return dispatch(any_hit, sub_nodes, f, node_rows, sub_leaves, sid_blk, rays,
                  n, block, scan_from, in_t, in_row, in_u, in_v, out_t,
                  out_row, out_u, out_v, s);
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
