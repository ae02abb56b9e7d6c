// Resident threaded-BVH walk (K1) for Hopper: closest hit and any-hit.
//
// Replaces the Pallas TPU kernel
// realtimepathtracingresearchframework_tpu/ops/traverse_pallas2.py::_kernel2
// (closest mode through closest_hit_pallas2, any-hit mode through
// occluded_pallas2). Its plain PyTorch version, which this kernel must
// equal bit for bit, is ops/traverse.py::walk_ranges.
//
// What it computes, per ray: walk the preorder node array from node 0.
// Enter a node when the slab test passes with t_far capped by the ray's best
// hit so far (tmax at the start); otherwise jump to the node's skip link. At
// a leaf, run Moller-Trumbore over its leaf_size rows in the expression
// order of traverse_pallas2._mt_leaf, with the |det| > 1e-12 guard and the
// hit test tt > tmin && tt < min(t_best, tmax). Closest mode keeps the
// nearest hit (strict improvement, so the lower row wins an exact-t tie)
// and writes t, row, u, v; a miss gives t = 2e32, row = -1, u = v = 0.
// Any-hit mode stops at the first hit and writes blocked = 1. The mode is
// per block: blocks from ``shadow_from`` on take the any-hit exit (all of
// them for an any-hit launch, none for a closest launch), so one launch
// can carry the wavefront's closest queue in its first blocks and the
// deferred shadow queue after it (the merged mode of
// traverse_pallas2.closest_and_occluded_pallas2); any-hit lane i writes
// blocked[i - shadow_from * blockDim.x].
//
// Design: one thread per ray, each running its own stackless walk. The
// TPU kernel's packet cursor, per-block interval bounds, 16-leaf SMEM flush
// list and pltpu.roll leaf slicing exist for the TPU's scalar unit and VMEM
// and are not carried over. Ints stay ints: links and rows are int32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py). No fast math: with contraction off and
// IEEE division the arithmetic rounds exactly like the plain version's
// separate tensor ops, so results compare bitwise.
//
// What bounds it on this card: divergent, latency-bound reads of node
// bounds, links and triangle rows (each step of a thread depends on the
// previous one's load), not FLOPs or bandwidth. The reads go through the
// read-only path (__ldg) and the tables are small enough to stay in L2.
// This design does nothing more about it yet; later work can stage the top
// of the node table in shared memory, reorder rays for coherence, or widen
// the tree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMax = 2.0e32f;
constexpr int kBlock = 128;

__device__ __forceinline__ float safe_inv(float d) {
  // ops/intersect.py::safe_inv_dir
  const float sign = d >= 0.0f ? 1.0f : -1.0f;
  return sign / fmaxf(fabsf(d), 1e-20f);
}

__global__ void __launch_bounds__(kBlock) traverse_resident_kernel(
    const float* __restrict__ bounds,  // (M, 6) min3, max3
    const int* __restrict__ links,     // (M, 2) skip, leaf index | -1
    const float* __restrict__ rows,    // (R, 9) v0, e1, e2
    int num_nodes, int leaf_size,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, int shadow_from,
    float* __restrict__ out_t, int* __restrict__ out_row,
    float* __restrict__ out_u, float* __restrict__ out_v,
    unsigned char* __restrict__ out_blocked) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool any_hit = static_cast<int>(blockIdx.x) >= shadow_from;
  const float rox = ox[i], roy = oy[i], roz = oz[i];
  const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
  const float tmin = tmin_in[i], tmax = tmax_in[i];
  const float ix = safe_inv(rdx), iy = safe_inv(rdy), iz = safe_inv(rdz);

  float t_best = tmax;
  int best_row = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool blocked = false;

  // an empty segment (tmax <= tmin) can never hit: it walks nothing
  int cur = tmax > tmin ? 0 : num_nodes;
  while (cur < num_nodes) {
    const float* b = bounds + 6 * cur;
    const float t0x = (__ldg(b + 0) - rox) * ix;
    const float t0y = (__ldg(b + 1) - roy) * iy;
    const float t0z = (__ldg(b + 2) - roz) * iz;
    const float t1x = (__ldg(b + 3) - rox) * ix;
    const float t1y = (__ldg(b + 4) - roy) * iy;
    const float t1z = (__ldg(b + 5) - roz) * iz;
    const float tenter = fmaxf(
        fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)), tmin);
    const float texit = fminf(
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)), t_best);
    const bool hit_box = tenter <= texit;
    const int skip = __ldg(links + 2 * cur);
    const int leaf = __ldg(links + 2 * cur + 1);

    if (hit_box && leaf >= 0) {
      const int row0 = leaf * leaf_size;
      for (int k = 0; k < leaf_size; ++k) {
        const float* r = rows + 9 * (row0 + k);
        const float v0x = __ldg(r + 0), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
        const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
        const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
        const float px = rdy * e2z - rdz * e2y;
        const float py = rdz * e2x - rdx * e2z;
        const float pz = rdx * e2y - rdy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool det_ok = fabsf(det) > 1e-12f;
        const float inv_det = det_ok ? 1.0f / det : 0.0f;
        const float tvx = rox - v0x;
        const float tvy = roy - v0y;
        const float tvz = roz - v0z;
        const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
        const float qx = tvy * e1z - tvz * e1y;
        const float qy = tvz * e1x - tvx * e1z;
        const float qz = tvx * e1y - tvy * e1x;
        const float vv = (rdx * qx + rdy * qy + rdz * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool hit = det_ok && uu >= 0.0f && vv >= 0.0f &&
                         uu + vv <= 1.0f && tt > tmin &&
                         tt < fminf(t_best, tmax);
        if (hit) {
          if (any_hit) {
            blocked = true;
            break;
          }
          // strict improvement in ascending row order: the lower row
          // keeps an exact-t tie
          t_best = tt;
          best_row = row0 + k;
          best_u = uu;
          best_v = vv;
        }
      }
      if (blocked) break;
    }
    cur = (hit_box && leaf < 0) ? cur + 1 : skip;
  }

  if (any_hit) {
    out_blocked[i - shadow_from * kBlock] = blocked ? 1 : 0;
  } else {
    out_t[i] = best_row < 0 ? kTMax : t_best;
    out_row[i] = best_row;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

}  // namespace

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched). Blocks of kBlock (128) rays; blocks
// from ``shadow_from`` on run the any-hit mode and write ``blocked`` (n -
// shadow_from * 128 flags), the blocks before it t, row, u, v (their
// lanes' worth). Closest mode: shadow_from >= the grid; any-hit: 0. The
// caller allocates every output.
extern "C" int rptr_traverse_resident(
    const float* bounds, const int* links, const float* rows, int num_nodes,
    int leaf_size, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmin,
    const float* tmax, int n, int shadow_from, float* out_t, int* out_row,
    float* out_u, float* out_v, unsigned char* out_blocked, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  if (shadow_from < 0) return cudaErrorInvalidValue;
  if (shadow_from > grid) shadow_from = grid;
  traverse_resident_kernel<<<grid, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      bounds, links, rows, num_nodes, leaf_size, ox, oy, oz, dx, dy, dz, tmin,
      tmax, n, shadow_from, out_t, out_row, out_u, out_v, out_blocked);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
