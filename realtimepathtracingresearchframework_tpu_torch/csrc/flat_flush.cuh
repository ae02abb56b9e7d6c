// The leaf flush of the flat-cull kernel K2 (traverse_flat_cull.cu), the
// per-lane ray and the output write (K3, traverse_precull.cu, tests each
// lane's own leaves with tlas_walk.cuh's warp-shared leaf test instead).
// One CUDA block is one group of q consecutive lanes (q = blockDim.x, a
// multiple of 32); each thread owns one lane.
//
// The flush: for every leaf in the block's survivor list, the block stages
// the leaf's leaf_size rows (9 floats each, v0, e1, e2) in shared memory,
// then every live thread runs Moller-Trumbore over them in the expression
// order of traverse_pallas2._mt_leaf (the order of K1 and of the plain
// version ops/traverse.py::_mt_rows). Hits in (tmin, tmax) merge on
// (t, row) lexicographically, so the survivor order does not matter and the
// result equals K1's walk (which keeps the lowest row of an exact-t tie)
// bit for bit. Any-hit mode stops the block once no live lane is unblocked.
//
// Built with --fmad=false and without fast math (kernels/build.py): every
// multiply and add rounds on its own, as in the plain version's tensor ops.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rptr_flat {

constexpr float kTMax = 2.0e32f;  // ops/intersect.py T_MAX
constexpr float kBig = 3.0e38f;   // empty box / dead-lane fill
constexpr int kRowNone = 0x7fffffff;

__device__ __forceinline__ float safe_inv(float d) {
  // ops/intersect.py::safe_inv_dir
  const float sign = d >= 0.0f ? 1.0f : -1.0f;
  return sign / fmaxf(fabsf(d), 1e-20f);
}

struct Lane {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
  bool live;  // tmax > tmin: a dead lane never hits and never blocks

  __device__ void load(const float* __restrict__ rays, int n, int i) {
    ox = rays[i];
    oy = rays[n + i];
    oz = rays[2 * n + i];
    dx = rays[3 * n + i];
    dy = rays[4 * n + i];
    dz = rays[5 * n + i];
    tmin = rays[6 * n + i];
    tmax = rays[7 * n + i];
    live = tmax > tmin;
  }
};

struct Best {
  float t = 0.0f;
  int row = kRowNone;
  float u = 0.0f, v = 0.0f;
  bool blocked = false;
};

// Moller-Trumbore of one lane against the ls staged rows of leaf ``leaf``.
template <bool kAnyHit>
__device__ __forceinline__ void mt_leaf(const float* __restrict__ stage,
                                        int leaf, int ls, const Lane& r,
                                        Best& b) {
  const int row0 = leaf * ls;
  for (int k = 0; k < ls; ++k) {
    const float* p = stage + 9 * k;
    const float v0x = p[0], v0y = p[1], v0z = p[2];
    const float e1x = p[3], e1y = p[4], e1z = p[5];
    const float e2x = p[6], e2y = p[7], e2z = p[8];
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool det_ok = fabsf(det) > 1e-12f;
    const float inv_det = det_ok ? 1.0f / det : 0.0f;
    const float tvx = r.ox - v0x;
    const float tvy = r.oy - v0y;
    const float tvz = r.oz - v0z;
    const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    const float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool hit = det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                     tt > r.tmin && tt < r.tmax;
    if (kAnyHit) {
      if (hit) {
        b.blocked = true;
        return;
      }
    } else if (hit && (b.row == kRowNone || tt < b.t ||
                       (tt == b.t && row0 + k < b.row))) {
      b.t = tt;
      b.row = row0 + k;
      b.u = uu;
      b.v = vv;
    }
  }
}

// Flush the block's ``count`` surviving leaves ``list`` (shared memory).
// Every thread of the block must call it (it synchronises).
template <bool kAnyHit>
__device__ void flush(const float* __restrict__ rows, int ls,
                      const int* list, int count, float* stage, const Lane& r,
                      Best& b) {
  const int nf = 9 * ls;
  for (int s = 0; s < count; ++s) {
    const int leaf = list[s];
    const float* src = rows + static_cast<size_t>(leaf) * nf;
    __syncthreads();  // the previous leaf's rows are no longer read
    for (int j = threadIdx.x; j < nf; j += blockDim.x) stage[j] = __ldg(src + j);
    __syncthreads();
    if (r.live && !b.blocked) mt_leaf<kAnyHit>(stage, leaf, ls, r, b);
    if (kAnyHit && !__syncthreads_or(r.live && !b.blocked)) break;
  }
}

template <bool kAnyHit>
__device__ __forceinline__ void write_out(int i, const Best& b,
                                          float* __restrict__ out_t,
                                          int* __restrict__ out_row,
                                          float* __restrict__ out_u,
                                          float* __restrict__ out_v,
                                          unsigned char* __restrict__ out_blocked) {
  if (kAnyHit) {
    out_blocked[i] = b.blocked ? 1 : 0;
  } else {
    const bool miss = b.row == kRowNone;
    out_t[i] = miss ? kTMax : b.t;
    out_row[i] = miss ? -1 : b.row;
    out_u[i] = miss ? 0.0f : b.u;
    out_v[i] = miss ? 0.0f : b.v;
  }
}

// Dynamic shared memory of one block: the survivor list (lpad ints) and
// the staged rows (9 * ls floats).
inline size_t smem_bytes(int lpad, int ls) {
  return sizeof(int) * static_cast<size_t>(lpad) +
         sizeof(float) * 9 * static_cast<size_t>(ls);
}

}  // namespace rptr_flat

extern "C" const char* rptr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
