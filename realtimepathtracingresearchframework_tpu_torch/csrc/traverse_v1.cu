// The v1 walk (K8a and K8b) for Hopper: closest hit, any-hit and the
// merged two-queue mode.
//
// Replaces the Pallas TPU kernels
// realtimepathtracingresearchframework_tpu/ops/traverse_pallas.py::_kernel
// (K8a: row-major (Rp, 16) triangle table, rays (8, Np), output (4, Np)) and
// ::_kernel_lane (K8b: field-major (16, Rp) table, rays (Np, 8), output
// (Np, 4)). Both walk the preorder node array of a leaf-128 threaded BVH
// (bounds (M, 6) f32, links (M, 2) int32: skip link, first leaf row or -1).
//
// K8a, the packet walk (plain version: ops/traverse_v1.py::plain): per
// packet of 512 rays sharing one cursor, at node ``cur`` every lane runs the
// slab test with its far distance capped by min(tmax, cap), where cap is
// the packet max of min(t_best, tmax) (max(tmax) at the start, recomputed
// after every step). If ANY lane passes and the node is a leaf, every lane
// runs Moller-Trumbore over the leaf's 128 rows in the expression order of
// traverse_pallas._kernel (the same as K1's, traverse_pallas2.py:237-239)
// against the t_best it had before the leaf, takes the leaf's least t
// (misses count as 2e32) and the first row that reaches it, and keeps it on
// a strict improvement. The next node is cur + 1 at a live inner node, else
// the skip link. Packets from ``early_from`` on (every packet of an any-hit
// launch, the shadow packets of a merged one, none of a closest one) stop
// once every lane is resolved: a hit found, or an empty segment (tmax <=
// tmin). Output per lane: t (2e32 on a miss), the row's int32 bits, u, v;
// u and v of a picked row come out as the reference's masked sum gives them
// (-0.0 becomes +0.0). Design: one block of 512 threads is one packet, one
// ray per thread (the reference's DEFAULT_BLOCK and the 32x16 workgroup it
// models); every thread reads node ``cur`` at the same address (a
// broadcast), __syncthreads_or gives the any-live vote, a visited leaf is
// copied into shared memory field-major and read as broadcasts, and cap is a
// warp-shuffle max and one shared slot per warp, published by the
// __syncthreads_and of the lanes' resolved flags.
//
// K8b, the per-lane walk (plain version: ops/traverse_v1.py::plain_lanes,
// the port's plain threaded walk ops/traverse.py::walk_ranges over the v1
// tables, K1's function): each lane walks its own ray, entering a node when
// its slab test passes with t_far capped by min(tmax, its best t), moving
// to cur + 1 at an entered inner node, else to the skip link; at an entered
// leaf it tests the leaf's 128 rows in the expression order above, takes
// the first least hit below min(best, tmax) (a strict improvement, so the
// first visited triangle keeps an exact-t tie). Lanes from ``early_from`` x
// 512 on are any-hit: they stop at their first hit. Output per lane: t (2e32
// on a miss), the row's int32 bits, u, v (-0.0 written as +0.0, as K8a's);
// an any-hit lane writes row 0 and t = tmax where its segment holds a hit,
// else row -1 and t = 2e32, u = v = 0. It differs from the packet walk only
// where a lane hits a triangle in a leaf whose box its own slab test
// rejects (a grazing lane: on a box face with a zero direction component,
// at a corner, or a 1-ulp gap between the slab t and Moller-Trumbore's t),
// which the packet tests because another lane entered it. Design:
// tlas_walk.cuh's: the walk is resumable state (V1Walk: cursor, best, the
// held leaf), stepped to the lane's next entered leaf with 8-byte node loads
// through the read-only path; then the warp serves the lanes' pending leaves
// (serve_leaves): a leaf that ``scan_from`` or more lanes hold is scanned by
// each holder in k order with broadcast loads, any other is tested by the
// whole warp, 4 triangles a lane from 9 coalesced 512-byte loads of the
// (16, Rp) table (ColumnTiles), with a shuffle reduction to the first least
// hit. Lanes that are done stay in the loop until no lane of the warp holds
// a leaf. The block size (a multiple of 32 dividing 512) does not change
// the result.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py). No fast math: with contraction off and
// IEEE division the arithmetic rounds as the plain versions' separate
// tensor ops do, so results compare bitwise. Ints stay ints: links and rows
// are int32.
//
// What bounds it on this card: for K8a, the packet's wasted
// Moller-Trumbore tests (a leaf is tested by all 512 lanes when any one
// enters it) and one to three block-wide barriers per node step; cornell's
// and small terrains' packets are coherent, so it stays. For K8b, the
// Moller-Trumbore work of each lane's own leaves and how much of the warp
// does it: the packet design it replaces walked the union of 512 rays'
// paths on the unsorted bounce and shadow queues the v1 route dispatches
// (48 ms on a 1080p terrain200 bounce-1 chunk against 0.67 ms on its
// primary chunk, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tlas_walk.cuh"

namespace {

constexpr float kInf = 2.0e32f;
constexpr int kBlock = 512;  // rays per packet; K8b's launch bound
constexpr int kLeaf = 128;
constexpr int kFields = 9;  // v0, e1, e2
constexpr int kWarps = kBlock / 32;
// K8b's defaults (PERF.md: measured on its queues)
constexpr int kLaneThreads = 128;
constexpr int kScanFrom = 24;

__device__ __forceinline__ float safe_inv(float d) {
  // ops/intersect.py::safe_inv_dir
  const float sign = d >= 0.0f ? 1.0f : -1.0f;
  return sign / fmaxf(fabsf(d), 1e-20f);
}

// The block max of x; every thread gets it. ``slots`` are written before
// the barrier ``sync_and(pred)`` and read after it; returns the barrier's
// value through ``all``.
__device__ __forceinline__ float block_max(float x, float* slots, bool pred,
                                           bool* all) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = x;
  *all = __syncthreads_and(pred) != 0;
  float m = slots[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, slots[w]);
  return m;
}

// K8a: the packet walk on the row-major (Rp, 16) table
__global__ void __launch_bounds__(kBlock) traverse_v1_kernel(
    const float* __restrict__ bounds,  // (M, 6) min3, max3
    const int* __restrict__ links,     // (M, 2) skip, first leaf row | -1
    const float* __restrict__ tris,    // (Rp, 16)
    int num_nodes,
    const float* __restrict__ rays,    // (8, Np)
    int np, int early_from,
    float* __restrict__ out) {         // (4, Np)
  __shared__ float leaf[kFields][kLeaf];
  __shared__ float slots[kWarps];
  const int lane = threadIdx.x;
  const size_t i = static_cast<size_t>(blockIdx.x) * kBlock + lane;
  float r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = rays[static_cast<size_t>(k) * np + i];
  const float rox = r[0], roy = r[1], roz = r[2];
  const float rdx = r[3], rdy = r[4], rdz = r[5];
  const float tmin = r[6], tmax = r[7];
  const float ix = safe_inv(rdx), iy = safe_inv(rdy), iz = safe_inv(rdz);
  const bool early = static_cast<int>(blockIdx.x) >= early_from;
  const bool dead = tmax <= tmin;

  float t_best = tmax;
  int best_row = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool all_resolved;
  float cap = block_max(tmax, slots, true, &all_resolved);

  int cur = 0;
  while (cur < num_nodes) {
    const float* b = bounds + 6 * cur;
    const float t0x = (__ldg(b + 0) - rox) * ix;
    const float t0y = (__ldg(b + 1) - roy) * iy;
    const float t0z = (__ldg(b + 2) - roz) * iz;
    const float t1x = (__ldg(b + 3) - rox) * ix;
    const float t1y = (__ldg(b + 4) - roy) * iy;
    const float t1z = (__ldg(b + 5) - roz) * iz;
    const float tenter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                               fmaxf(fminf(t0z, t1z), tmin));
    const float texit = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                              fminf(fmaxf(t0z, t1z), fminf(tmax, cap)));
    const int skip = __ldg(links + 2 * cur);
    const int leaf_row = __ldg(links + 2 * cur + 1);
    const bool any_live = __syncthreads_or(tenter <= texit) != 0;
    const bool is_leaf = leaf_row >= 0;

    if (any_live && is_leaf) {  // uniform over the block
      for (int e = lane; e < kFields * kLeaf; e += kBlock) {
        const int f = e / kLeaf, k = e % kLeaf;
        leaf[f][k] = __ldg(tris + static_cast<size_t>(leaf_row + k) * 16 + f);
      }
      __syncthreads();
      const float lim = fminf(t_best, tmax);
      // the least hit t with its first row, and whether any row missed:
      // the reference's column min fills misses with 2e32
      bool found = false, any_miss = false;
      float bt = 0.0f, bu = 0.0f, bv = 0.0f;
      int bi = kLeaf;
      for (int k = 0; k < kLeaf; ++k) {
        const float v0x = leaf[0][k], v0y = leaf[1][k], v0z = leaf[2][k];
        const float e1x = leaf[3][k], e1y = leaf[4][k], e1z = leaf[5][k];
        const float e2x = leaf[6][k], e2y = leaf[7][k], e2z = leaf[8][k];
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
                         uu + vv <= 1.0f && tt > tmin && tt < lim;
        if (hit) {
          if (!found || tt < bt) {
            bt = tt;
            bi = k;
            bu = uu;
            bv = vv;
          }
          found = true;
        } else {
          any_miss = true;
        }
      }
      const float t_col = !found ? kInf : (any_miss ? fminf(bt, kInf) : bt);
      if (t_col < t_best) {
        const int sub = (found && bt <= t_col) ? bi : kLeaf;
        t_best = t_col;
        best_row = leaf_row + sub;
        best_u = (sub < kLeaf && bu != 0.0f) ? bu : 0.0f;
        best_v = (sub < kLeaf && bv != 0.0f) ? bv : 0.0f;
      }
    }
    const bool resolved = best_row >= 0 || dead;
    cap = block_max(fminf(t_best, tmax), slots, resolved, &all_resolved);
    if (early && all_resolved) break;
    cur = (any_live && !is_leaf) ? cur + 1 : skip;
  }

  out[i] = best_row < 0 ? kInf : t_best;
  out[static_cast<size_t>(np) + i] = __int_as_float(best_row);
  out[2 * static_cast<size_t>(np) + i] = best_u;
  out[3 * static_cast<size_t>(np) + i] = best_v;
}

using rptr_stream::Best;
using rptr_stream::Ray;
using rptr_tlas::kFull;

// K8b: one lane's resumable walk of the v1 tree, stepped to its next
// entered leaf (whose first row it then holds) or to its end
struct V1Walk {
  Ray r;
  Best b;
  bool done;
  int cur = 0;
  int leaf_row = 0;

  __device__ __forceinline__ bool step(const float* __restrict__ bounds,
                                       const int* __restrict__ links,
                                       int num_nodes) {
    while (!done) {
      if (cur >= num_nodes) {
        done = true;
        break;
      }
      // the node's 24-byte box as three 8-byte loads, its links as one
      const float2* bp = reinterpret_cast<const float2*>(bounds) + 3 * cur;
      const float2 lo = __ldg(bp), mid = __ldg(bp + 1), hi = __ldg(bp + 2);
      const float box[6] = {lo.x, lo.y, mid.x, mid.y, hi.x, hi.y};
      const int2 l = __ldg(reinterpret_cast<const int2*>(links) + cur);
      const bool hit_box = rptr_stream::slab(box, r, b.t);
      cur = (hit_box && l.y < 0) ? cur + 1 : l.x;
      if (hit_box && l.y >= 0) {
        leaf_row = l.y;
        return true;
      }
    }
    return false;
  }
};

// One lane's walk and its (t, row bits, u, v). Every lane of the warp must
// call it.
template <bool kAnyHit>
__device__ __forceinline__ float4 walk_lane(const float* __restrict__ bounds,
                                            const int* __restrict__ links,
                                            int num_nodes,
                                            const rptr_tlas::ColumnTiles& tiles,
                                            int scan_from, const Ray& r) {
  // an empty segment (tmax <= tmin) walks nothing, as in walk_ranges
  V1Walk w{r, Best{r.tmax, -1, 0.0f, 0.0f, false}, !(r.tmax > r.tmin)};
  for (;;) {
    const bool pending = w.step(bounds, links, num_nodes);
    const unsigned pend = __ballot_sync(kFull, pending);
    if (pend == 0) break;
    rptr_tlas::serve_leaves<kAnyHit>(pending, pend, tiles, r, w.leaf_row,
                                     w.leaf_row, scan_from, w.b);
    if (kAnyHit && w.b.blocked) w.done = true;
  }
  if (kAnyHit) {
    return w.b.blocked ? make_float4(r.tmax, __int_as_float(0), 0.0f, 0.0f)
                       : make_float4(kInf, __int_as_float(-1), 0.0f, 0.0f);
  }
  return make_float4(w.b.row < 0 ? kInf : w.b.t, __int_as_float(w.b.row),
                     w.b.u == 0.0f ? 0.0f : w.b.u,
                     w.b.v == 0.0f ? 0.0f : w.b.v);
}

// K8b on the field-major (16, Rp) table, rays (Np, 8), output (Np, 4); the
// grid covers Np exactly. Lanes from early_from * 512 on are any-hit,
// which is uniform per warp.
__global__ void __launch_bounds__(kBlock) traverse_v1_lanes_kernel(
    const float* __restrict__ bounds, const int* __restrict__ links,
    const float* __restrict__ tris, int rp, int num_nodes,
    const float* __restrict__ rays, int early_from, int scan_from,
    float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* rr = reinterpret_cast<const float4*>(rays) + 2 * i;
  const float4 a = __ldg(rr), c = __ldg(rr + 1);
  Ray r;
  r.ox = a.x;
  r.oy = a.y;
  r.oz = a.z;
  r.dx = a.w;
  r.dy = c.x;
  r.dz = c.y;
  r.tmin = c.z;
  r.tmax = c.w;
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  const rptr_tlas::ColumnTiles tiles{tris, rp};
  float4* o = reinterpret_cast<float4*>(out) + i;
  if (i >= static_cast<size_t>(early_from) * kBlock) {
    *o = walk_lane<true>(bounds, links, num_nodes, tiles, scan_from, r);
  } else {
    *o = walk_lane<false>(bounds, links, num_nodes, tiles, scan_from, r);
  }
}

int launch_lanes(const float* bounds, const int* links, const float* tris,
                 int rp, int num_nodes, const float* rays, int np,
                 int early_from, float* out, cudaStream_t s, int threads,
                 int scan_from) {
  if (threads <= 0) threads = kLaneThreads;
  if (scan_from < 0) scan_from = kScanFrom;
  if (threads > kBlock || kBlock % threads || threads % 32 || rp % kLeaf) {
    return cudaErrorInvalidValue;
  }
  traverse_v1_lanes_kernel<<<np / threads, threads, 0, s>>>(
      bounds, links, tris, rp, num_nodes, rays, early_from, scan_from, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 = launched); ``np`` is a multiple of 512. ``wide``
// picks K8a (row-major table, (8, np) rays, (4, np) output; np / 512
// blocks) or K8b (field-major table, (np, 8) rays, (np, 4) output; its
// default block size and scan_from). Packets of 512 lanes from
// ``early_from`` on take the any-hit mode (0 for an any-hit launch, the
// first shadow packet of a merged one, np / 512 for a closest one). The
// caller allocates the output; K8b reads ``bounds``, ``links``, ``tris``,
// ``rays`` and writes ``out`` with 8- and 16-byte loads and stores, so the
// wrapper checks their alignment.
extern "C" int rptr_traverse_v1(const float* bounds, const int* links,
                                const float* tris, int rp, int num_nodes,
                                const float* rays, int np, int early_from,
                                int wide, float* out, void* stream) {
  if (np <= 0) return 0;
  if (np % kBlock != 0 || early_from < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!wide) {
    return launch_lanes(bounds, links, tris, rp, num_nodes, rays, np,
                        early_from, out, s, 0, -1);
  }
  traverse_v1_kernel<<<np / kBlock, kBlock, 0, s>>>(
      bounds, links, tris, num_nodes, rays, np, early_from, out);
  return static_cast<int>(cudaGetLastError());
}

// K8b with its block size ``threads`` (a multiple of 32 dividing 512; 0:
// the default) and ``scan_from`` (a leaf that this many lanes of a warp
// hold is scanned by each of them alone; > 32 never; < 0: the default);
// otherwise as rptr_traverse_v1 with wide = 0. The result does not depend
// on either.
extern "C" int rptr_traverse_v1_lanes(const float* bounds, const int* links,
                                      const float* tris, int rp,
                                      int num_nodes, const float* rays,
                                      int np, int early_from, float* out,
                                      void* stream, int threads,
                                      int scan_from) {
  if (np <= 0) return 0;
  if (np % kBlock != 0 || early_from < 0) return cudaErrorInvalidValue;
  return launch_lanes(bounds, links, tris, rp, num_nodes, rays, np,
                      early_from, out, static_cast<cudaStream_t>(stream),
                      threads, scan_from);
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
