// Shared parts of the streamed and two-level kernels: the ray, the slab
// test (with its zero-direction rule, slab_axis) and the object ray of an
// instance (K6, K7). The walks of K4
// (traverse_streamed.cu), K5 (traverse_binned.cu), K6 (traverse_tlas.cu)
// and K7 (traverse_tlas_stream.cu), with warp-shared leaf tests, are
// tlas_walk.cuh's.
//
// A subtree of the streamed pack (ops/traverse_stream.py::pack_streamed)
// is a node block of slots = node_rows * 16 nodes of 8 floats, node i at
// offset 8 * i: [min3, max3, skip, local leaf id | -1]. The links are
// float VALUES (exact below 2^24), read with a float -> int conversion; a
// skip of SUB_EXIT (255) lies past the last slot and leaves the subtree.
// Leaf l of the subtree owns the field-major tile tile0 + l * 16 * 128: row
// f holds field f (v0, e1, e2 xyz) of its 128 triangles. Quantized packs
// (pack_streamed(quantize=True)) hold int16 codes in the same layout and
// each subtree's grid in the last slot of its node block
// (tlas_walk.cuh::QuantTiles decodes them).
//
// Built with --fmad=false and without fast math (kernels/build.py): every
// multiply and add rounds on its own, as in the plain version's tensor ops.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rptr_stream {

constexpr float kTMax = 2.0e32f;  // ops/intersect.py T_MAX
constexpr int kLeaf = 128;        // triangles per leaf tile
constexpr int kThreads = 128;     // threads per CUDA block

// ops/intersect.py::safe_inv_dir, but +inf for a component of exactly 0
// (either sign), which slab_axis turns into the zero-direction rule
__device__ __forceinline__ float safe_inv(float d) {
  if (d == 0.0f) return INFINITY;
  const float sign = d >= 0.0f ? 1.0f : -1.0f;
  return sign / fmaxf(fabsf(d), 1e-20f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax, ix, iy, iz;

  // lane i of a packed (8, n) operand [ro3, rd3, tmin, tmax]
  __device__ void load(const float* __restrict__ rays, int n, int i) {
    ox = rays[i];
    oy = rays[n + i];
    oz = rays[2 * n + i];
    dx = rays[3 * n + i];
    dy = rays[4 * n + i];
    dz = rays[5 * n + i];
    tmin = rays[6 * n + i];
    tmax = rays[7 * n + i];
    ix = safe_inv(dx);
    iy = safe_inv(dy);
    iz = safe_inv(dz);
  }
};

// World ray -> object ray of an instance (the two-level kernels K6, K7) by
// its inverse affine a[0:12] (A^-1 rows, then its translation), the
// direction NOT renormalised, so object-space t is world t. The sums run in
// the order of ops/tlas.py::object_ray (and of the reference kernels,
// traverse_tlas.py:246-251); safe_inv of the OBJECT direction.
__device__ __forceinline__ Ray object_ray(const float* __restrict__ a,
                                          const Ray& w) {
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = __ldg(a + k);
  Ray r;
  r.ox = m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[9];
  r.oy = m[3] * w.ox + m[4] * w.oy + m[5] * w.oz + m[10];
  r.oz = m[6] * w.ox + m[7] * w.oy + m[8] * w.oz + m[11];
  r.dx = m[0] * w.dx + m[1] * w.dy + m[2] * w.dz;
  r.dy = m[3] * w.dx + m[4] * w.dy + m[5] * w.dz;
  r.dz = m[6] * w.dx + m[7] * w.dy + m[8] * w.dz;
  r.tmin = w.tmin;
  r.tmax = w.tmax;
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

struct Best {
  float t;  // the segment end while nothing is found
  int row;  // global row, -1 = none
  float u, v;
  bool blocked;
};

// One axis of the slab test (ops/intersect.py::slab_interval): the entry
// and exit t of the slab [lo, hi] (lo <= hi) along a ray from o with
// i = safe_inv(d): the products of the near and the far plane, which are
// the plain version's min and max of the two products bit for bit (a
// product is monotone in each factor). On an axis where d is exactly 0, i
// is +inf: below the slab both products are +inf and above it both -inf
// (the slab is empty), inside it the near one is -inf and the far one +inf,
// and on a face the product 0 x inf is NaN, which the fmaxf / fminf of the
// callers drop (IEEE maxNum / minNum): the slab is the whole line there, as
// the plain version's (-inf, +inf). The products with 1e20 would put the
// exit of a ray on the max face at 0 and miss a box the ray runs along.
__device__ __forceinline__ void slab_axis(float lo, float hi, float o, float i,
                                          float& tsmall, float& tbig) {
  const bool pos = i > 0.0f;
  tsmall = ((pos ? lo : hi) - o) * i;
  tbig = ((pos ? hi : lo) - o) * i;
}

// ops/intersect.py::ray_aabb on the node box b[0:6], segment [tmin, tcap];
// ``tenter`` receives the entry t
__device__ __forceinline__ bool slab_entry(const float* b, const Ray& r,
                                           float tcap, float& tenter) {
  float sx, bx, sy, by, sz, bz;
  slab_axis(b[0], b[3], r.ox, r.ix, sx, bx);
  slab_axis(b[1], b[4], r.oy, r.iy, sy, by);
  slab_axis(b[2], b[5], r.oz, r.iz, sz, bz);
  tenter = fmaxf(fmaxf(fmaxf(sx, sy), sz), r.tmin);
  const float texit = fminf(fminf(fminf(bx, by), bz), tcap);
  return tenter <= texit;
}

__device__ __forceinline__ bool slab(const float* b, const Ray& r,
                                     float tcap) {
  float tenter;
  return slab_entry(b, r, tcap, tenter);
}

}  // namespace rptr_stream
