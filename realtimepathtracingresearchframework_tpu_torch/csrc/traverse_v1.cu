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
// What both compute (plain version: ops/traverse_v1.py::plain_lanes, the
// port's plain threaded walk ops/traverse.py::walk_ranges over the v1
// tables, K1's function): each lane walks its own ray, entering a node when
// its slab test passes with t_far capped by min(tmax, its best t), moving
// to cur + 1 at an entered inner node, else to the skip link; at an entered
// leaf it tests the leaf's rows in the expression order of
// traverse_pallas._kernel (the same as K1's, traverse_pallas2.py:237-239),
// takes the first least hit below min(best, tmax) (a strict improvement, so
// the first visited triangle keeps an exact-t tie). Lanes from
// ``early_from`` x 512 on are any-hit: they stop at their first hit. Output
// per lane: t (2e32 on a miss), the row's int32 bits, u, v (-0.0 written as
// +0.0, as the reference's masked sum writes it); an any-hit lane writes row
// 0 and t = tmax where its segment holds a hit, else row -1 and t = 2e32,
// u = v = 0. The reference's packet walk (ops/traverse_v1.py::plain: a
// packet of 512 rays sharing one cursor, a leaf tested by every lane when
// any lane enters it) differs only where a lane hits a triangle in a leaf
// whose box its own slab test rejects (a grazing lane: at a corner, or a
// 1-ulp gap between the slab t and Moller-Trumbore's t; a ray along a box
// face with a zero direction component enters the box, slab_axis), which
// the packet tests because another lane
// entered it (ROADMAP queue 3; chip_smoke.py counts them).
//
// Design: tlas_walk.cuh's walk_threaded, one template for K8a, K8b and K1:
// each lane's walk is resumable state (LaneWalk: cursor, best, the held
// leaf), stepped to its next entered leaf with 8-byte node loads through the
// read-only path; then the warp serves the lanes' pending leaves
// (serve_leaves): a leaf that ``scan_from`` or more lanes hold is scanned by
// each holder in k order with broadcast loads (four 64-byte rows of the
// (Rp, 16) table from 16-byte loads per step, WideRows; or 4 triangles of
// the (16, Rp) table from 9 16-byte loads, ColumnTiles), any other is
// tested by the whole warp with a shuffle reduction to the first least hit.
// The holders' scan stops a leaf at its real-row count (the packs pad a
// leaf by repeating its last triangle, and cornell's one leaf holds 32
// triangles in 128 rows), and so does K8a's warp test, which takes the
// leaf's rows strided (lane j rows j, j + 32, ...: ceil(c / 32) steps for c
// real rows); K8b's warp test keeps its 9 coalesced 512-byte loads of 4
// rows a lane, measured faster on its table (PERF.md). Lanes that are done
// stay in the loop until no lane of the warp holds a leaf. The two kernels
// differ only in the table's loader and in the ray and output layouts, the
// reference's. The block size (a multiple of 32 dividing 512) does not
// change the result.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py). No fast math: with contraction off and
// IEEE division the arithmetic rounds as the plain versions' separate
// tensor ops do, so results compare bitwise. Ints stay ints: links and rows
// are int32.
//
// What bounds it on this card: the Moller-Trumbore work of each lane's own
// leaves and how much of the warp does it. The packet design this replaces
// tested every row of every leaf any of 512 lanes entered, with up to three
// block barriers per node step: on cornell 96 of its 128 rows per ray were
// padding, and on incoherent queues of multi-leaf tables (terrain40's
// unsorted bounce 1: 6.76 ms against 0.14 ms on its other queues) the
// packet walked the union of 512 rays' paths (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tlas_walk.cuh"

namespace {

using rptr_stream::Best;
using rptr_stream::Ray;

constexpr float kInf = 2.0e32f;
constexpr int kBlock = 512;  // rays per packet; the launch bound
constexpr int kLeaf = 128;
// the defaults (PERF.md: measured on each kernel's queues): 128 threads for
// both, scan_from 8 for K8a and 24 for K8b
constexpr int kThreads = 128;
constexpr int kScanFromWide = 8;
constexpr int kScanFrom = 24;

// One lane's (t, row bits, u, v). Every lane of the warp must call it.
template <bool kAnyHit, class Tiles>
__device__ __forceinline__ float4 walk_lane(const rptr_tlas::Threaded& t,
                                            const Tiles& tiles, int scan_from,
                                            const Ray& r) {
  const Best b =
      rptr_tlas::walk_threaded<kAnyHit>(t, tiles, scan_from, r, true);
  if (kAnyHit) {
    return b.blocked ? make_float4(r.tmax, __int_as_float(0), 0.0f, 0.0f)
                     : make_float4(kInf, __int_as_float(-1), 0.0f, 0.0f);
  }
  return make_float4(b.row < 0 ? kInf : b.t, __int_as_float(b.row),
                     b.u == 0.0f ? 0.0f : b.u, b.v == 0.0f ? 0.0f : b.v);
}

// K8a (kWide: row-major (Rp, 16) table, rays (8, Np), output (4, Np)) or
// K8b (field-major (16, Rp) table, rays (Np, 8), output (Np, 4)); the grid
// covers Np exactly. Lanes from early_from * 512 on are any-hit, which is
// uniform per warp.
template <bool kWide>
__global__ void __launch_bounds__(kBlock) traverse_v1_kernel(
    rptr_tlas::Threaded t, const float* __restrict__ tris, int rp,
    const float* __restrict__ rays, int np, int early_from, int scan_from,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  if (kWide) {
    r.load(rays, np, i);
  } else {
    const float4* rr = reinterpret_cast<const float4*>(rays) + 2 * i;
    const float4 a = __ldg(rr), c = __ldg(rr + 1);
    r.ox = a.x;
    r.oy = a.y;
    r.oz = a.z;
    r.dx = a.w;
    r.dy = c.x;
    r.dz = c.y;
    r.tmin = c.z;
    r.tmax = c.w;
    r.ix = rptr_stream::safe_inv(r.dx);
    r.iy = rptr_stream::safe_inv(r.dy);
    r.iz = rptr_stream::safe_inv(r.dz);
  }
  const bool any_hit = i >= early_from * kBlock;
  float4 o;
  if (kWide) {
    const rptr_tlas::WideRows tiles{tris};
    o = any_hit ? walk_lane<true>(t, tiles, scan_from, r)
                : walk_lane<false>(t, tiles, scan_from, r);
    out[i] = o.x;
    out[np + i] = o.y;
    out[2 * np + i] = o.z;
    out[3 * np + i] = o.w;
  } else {
    const rptr_tlas::ColumnTiles tiles{tris, rp};
    o = any_hit ? walk_lane<true>(t, tiles, scan_from, r)
                : walk_lane<false>(t, tiles, scan_from, r);
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

}  // namespace

// Plain C entry for ctypes. Launches K8a (``wide``: row-major table, (8,
// np) rays, (4, np) output) or K8b (field-major table, (np, 8) rays, (np,
// 4) output) on ``stream`` and returns cudaGetLastError() (0 = launched);
// ``np`` is a multiple of 512. Packets of 512 lanes from ``early_from`` on
// take the any-hit mode (0 for an any-hit launch, the first shadow packet of
// a merged one, np / 512 for a closest one). ``counts`` holds each leaf's
// real-row count (Rp / 128 of them). ``threads`` is the block size (a
// multiple of 32 dividing 512; 0: the default) and ``scan_from`` the leaf
// service (a leaf that this many lanes of a warp hold is scanned by each of
// them alone; > 32 never; < 0: the default); the result depends on
// neither. The kernels read ``bounds``, ``links``, ``tris`` and K8b's
// ``rays`` and ``out`` with 8- and 16-byte loads and stores, so the wrapper
// checks their alignment; the caller allocates the output.
extern "C" int rptr_traverse_v1(const float* bounds, const int* links,
                                const int* counts, const float* tris, int rp,
                                int num_nodes, const float* rays, int np,
                                int early_from, int wide, float* out,
                                void* stream, int threads, int scan_from) {
  if (np <= 0) return 0;
  if (threads <= 0) threads = kThreads;
  if (scan_from < 0) scan_from = wide ? kScanFromWide : kScanFrom;
  if (np % kBlock != 0 || early_from < 0 || threads > kBlock ||
      kBlock % threads || threads % 32 || rp % kLeaf) {
    return cudaErrorInvalidValue;
  }
  const rptr_tlas::Threaded t{bounds, links, counts, num_nodes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    traverse_v1_kernel<true><<<np / threads, threads, 0, s>>>(
        t, tris, rp, rays, np, early_from, scan_from, out);
  } else {
    traverse_v1_kernel<false><<<np / threads, threads, 0, s>>>(
        t, tris, rp, rays, np, early_from, scan_from, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
