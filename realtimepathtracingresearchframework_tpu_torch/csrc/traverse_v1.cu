// The v1 packet walk (K8a and K8b) for Hopper: closest hit, any-hit and
// the merged two-queue mode.
//
// Replaces the Pallas TPU kernels
// realtimepathtracingresearchframework_tpu/ops/traverse_pallas.py::_kernel
// (K8a: row-major (Rp, 16) triangle table, rays (8, Np), output (4, Np)) and
// ::_kernel_lane (K8b: field-major (16, Rp) table, rays (Np, 8), output
// (Np, 4)). Its plain PyTorch version, which this kernel must equal bit for
// bit, is ops/traverse_v1.py::plain.
//
// What it computes, per packet of 512 rays sharing one cursor over the
// preorder node array of a leaf-128 threaded BVH: at node ``cur`` every
// lane runs the slab test with its far distance capped by min(tmax, cap),
// where cap is the packet max of min(t_best, tmax) (max(tmax) at the start,
// recomputed after every step). If ANY lane passes and the node is a leaf,
// every lane runs Moller-Trumbore over the leaf's 128 rows in the
// expression order of traverse_pallas._kernel (the same as K1's,
// traverse_pallas2.py:237-239) against the t_best it had before the leaf,
// takes the leaf's least t (misses count as 2e32) and the first row that
// reaches it, and keeps it on a strict improvement. The next node is cur + 1
// at a live inner node, else the skip link. Packets from ``early_from`` on
// (every packet of an any-hit launch, the shadow packets of a merged one,
// none of a closest one) stop once every lane is resolved: a hit found, or
// an empty segment (tmax <= tmin). Output per lane: t (2e32 on a miss), the
// row's int32 bits, u, v; u and v of a picked row come out as the
// reference's masked sum gives them (-0.0 becomes +0.0).
//
// Design: one block of 512 threads is one packet, one ray per thread (the
// reference's DEFAULT_BLOCK and the 32x16 workgroup it models). Every
// thread reads node ``cur`` at the same address, a broadcast through the
// read-only path. __syncthreads_or gives the packet's any-live vote. At a
// visited leaf the block copies the 128 x 9 floats (4.5 KB) into shared
// memory field-major, then each thread reads them as broadcasts. cap is a
// warp-shuffle max and one shared slot per warp; the barrier that publishes
// the slots is __syncthreads_and of the lanes' resolved flags, which also
// gives the any-hit exit. The table layout is the template parameter kWide.
// Ints stay ints: links and rows are int32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (kernels/build.py). No fast math: with contraction off and
// IEEE division the arithmetic rounds as the plain version's separate
// tensor ops do, so results compare bitwise.
//
// What bounds it on this card: the packet's wasted Moller-Trumbore tests.
// A leaf is tested by all 512 lanes when any one of them enters it, so on
// the unsorted bounce and shadow queues the v1 route dispatches a packet
// walks the union of its rays' paths; and each node step costs one or two
// block-wide barriers (three at a leaf). This design does nothing more
// about either yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 2.0e32f;
constexpr int kBlock = 512;
constexpr int kLeaf = 128;
constexpr int kFields = 9;  // v0, e1, e2
constexpr int kWarps = kBlock / 32;

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

template <bool kWide>
__global__ void __launch_bounds__(kBlock) traverse_v1_kernel(
    const float* __restrict__ bounds,  // (M, 6) min3, max3
    const int* __restrict__ links,     // (M, 2) skip, first leaf row | -1
    const float* __restrict__ tris,    // (Rp, 16) if kWide, else (16, Rp)
    int rp, int num_nodes,
    const float* __restrict__ rays,    // (8, Np) if kWide, else (Np, 8)
    int np, int early_from,
    float* __restrict__ out) {         // (4, Np) if kWide, else (Np, 4)
  __shared__ float leaf[kFields][kLeaf];
  __shared__ float slots[kWarps];
  const int lane = threadIdx.x;
  const size_t i = static_cast<size_t>(blockIdx.x) * kBlock + lane;
  float r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    r[k] = kWide ? rays[static_cast<size_t>(k) * np + i] : rays[i * 8 + k];
  }
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
        leaf[f][k] = kWide
            ? __ldg(tris + static_cast<size_t>(leaf_row + k) * 16 + f)
            : __ldg(tris + static_cast<size_t>(f) * rp + leaf_row + k);
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

  const float t_out = best_row < 0 ? kInf : t_best;
  const float row_bits = __int_as_float(best_row);
  if (kWide) {
    out[i] = t_out;
    out[static_cast<size_t>(np) + i] = row_bits;
    out[2 * static_cast<size_t>(np) + i] = best_u;
    out[3 * static_cast<size_t>(np) + i] = best_v;
  } else {
    out[i * 4 + 0] = t_out;
    out[i * 4 + 1] = row_bits;
    out[i * 4 + 2] = best_u;
    out[i * 4 + 3] = best_v;
  }
}

}  // namespace

// Plain C entry for ctypes. Launches np / 512 blocks on ``stream`` and
// returns cudaGetLastError() (0 = launched). ``wide`` picks K8a (row-major
// table, (8, np) rays, (4, np) output) or K8b (field-major table, (np, 8)
// rays, (np, 4) output); blocks from ``early_from`` on take the any-hit exit
// (0 for an any-hit launch, the first shadow packet of a merged one, the
// grid for a closest one). The caller allocates the output.
extern "C" int rptr_traverse_v1(const float* bounds, const int* links,
                                const float* tris, int rp, int num_nodes,
                                const float* rays, int np, int early_from,
                                int wide, float* out, void* stream) {
  if (np <= 0) return 0;
  if (np % kBlock != 0 || early_from < 0) return cudaErrorInvalidValue;
  const int grid = np / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    traverse_v1_kernel<true><<<grid, kBlock, 0, s>>>(
        bounds, links, tris, rp, num_nodes, rays, np, early_from, out);
  } else {
    traverse_v1_kernel<false><<<grid, kBlock, 0, s>>>(
        bounds, links, tris, rp, num_nodes, rays, np, early_from, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
