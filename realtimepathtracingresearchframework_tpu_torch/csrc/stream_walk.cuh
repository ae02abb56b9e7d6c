// Shared parts of the streamed and two-level kernels: the ray, the slab
// test, the object ray of an instance (K6, K7), the quantized grid of a
// subtree, and K5's walk of one subtree of the streamed pack
// (ops/traverse_stream.py::pack_streamed, traverse_binned.cu), one thread
// per ray with Moller-Trumbore over the 128 triangles of every entered
// leaf. The walks of K4 (traverse_streamed.cu), K6 (traverse_tlas.cu) and
// K7 (traverse_tlas_stream.cu), with warp-shared leaf tests, are
// tlas_walk.cuh's.
//
// A subtree's node block is slots = node_rows * 16 nodes of 8 floats, node
// i at offset 8 * i: [min3, max3, skip, local leaf id | -1]. The links are
// float VALUES (exact below 2^24), read with a float -> int conversion; a
// skip of SUB_EXIT (255) lies past the last slot and leaves the subtree.
// Leaf l of the subtree owns the field-major tile tile0 + l * 16 * 128: row
// f holds field f (v0, e1, e2 xyz) of its 128 triangles, so the 32 threads
// of a warp that test the same triangle read one address (a broadcast).
//
// The walk equals the port's plain threaded walk (ops/traverse.py::walk_ranges)
// on the subtree decoded to the resident layout
// (traverse_stream.subtree_resident): enter a node when the slab test
// passes with t_far capped by the ray's best hit, else jump to its skip
// link; at a leaf, test its triangles in ascending order in the expression
// order of traverse_pallas2._mt_leaf, accepting tt > tmin and
// tt < min(t_best, tmax), so a hit improves strictly and the first visited
// triangle keeps an exact-t tie.
//
// Quantized packs (traverse_stream.pack_streamed(quantize=True)) hold int16
// codes, offset by -32768, in the same tile layout (rows 0-8: q0, q1, q2
// xyz), and each subtree's grid min and scale in the first six floats of the
// last slot of its node block, which no walk lands on. The leaf loop decodes
// a triangle as traverse_stream.dequant_tile does: v0 = c + (q0 + 32768) * s
// and the edges (qk - q0) * s, the codes going int16 -> int -> float (never
// through float bit patterns), so the decoded triangle is bitwise
// traverse_stream.reconstruct_quantized's.
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

__device__ __forceinline__ float safe_inv(float d) {
  // ops/intersect.py::safe_inv_dir
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

// ops/intersect.py::ray_aabb on the node box b[0:6], segment [tmin, tcap];
// ``tenter`` receives the entry t
__device__ __forceinline__ bool slab_entry(const float* b, const Ray& r,
                                           float tcap, float& tenter) {
  const float t0x = (b[0] - r.ox) * r.ix;
  const float t0y = (b[1] - r.oy) * r.iy;
  const float t0z = (b[2] - r.oz) * r.iz;
  const float t1x = (b[3] - r.ox) * r.ix;
  const float t1y = (b[4] - r.oy) * r.iy;
  const float t1z = (b[5] - r.oz) * r.iz;
  tenter = fmaxf(
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)), r.tmin);
  const float texit = fminf(
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)), tcap);
  return tenter <= texit;
}

__device__ __forceinline__ bool slab(const float* b, const Ray& r,
                                     float tcap) {
  float tenter;
  return slab_entry(b, r, tcap, tenter);
}

// The grid of a quantized subtree: min xyz, scale xyz
struct Dequant {
  float c[3], s[3];
};

// The constants of a subtree from the last slot of its node block
__device__ __forceinline__ Dequant dequant_of(const float* nodes, int slots) {
  const float* q = nodes + 8 * (slots - 1);
  return Dequant{{q[0], q[1], q[2]}, {q[3], q[4], q[5]}};
}

// Triangle k of a field-major leaf tile: v0, e1, e2 xyz
__device__ __forceinline__ void load_tri(const float* __restrict__ tile,
                                         int k, const Dequant&,
                                         float (&f)[9]) {
#pragma unroll
  for (int j = 0; j < 9; ++j) f[j] = __ldg(tile + j * kLeaf + k);
}

// Triangle k of a quantized tile, decoded in traverse_stream.dequant_tile's
// expression order
__device__ __forceinline__ void load_tri(const int16_t* __restrict__ tile,
                                         int k, const Dequant& dq,
                                         float (&f)[9]) {
  float q[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    q[j] = static_cast<float>(static_cast<int>(__ldg(tile + j * kLeaf + k)));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f[a] = dq.c[a] + (q[a] + 32768.0f) * dq.s[a];
    f[3 + a] = (q[3 + a] - q[a]) * dq.s[a];
    f[6 + a] = (q[6 + a] - q[a]) * dq.s[a];
  }
}

// Walk one subtree: ``nodes`` its node block (shared or global memory),
// ``tile0`` its first leaf tile (f32, or int16 codes decoded with ``dq``),
// ``row0`` the global row of its first triangle. Closest mode updates b (t,
// row, u, v); any-hit mode sets b.blocked at the first hit and returns.
template <bool kAnyHit, typename Tile>
__device__ void walk_subtree(const float* nodes, int slots,
                             const Tile* __restrict__ tile0, int row0,
                             const Ray& r, Best& b, const Dequant& dq) {
  int c = 0;
  while (c < slots) {
    const float* nd = nodes + 8 * c;
    const bool hit_box = slab(nd, r, b.t);
    const int skip = static_cast<int>(nd[6]);
    const int leaf = static_cast<int>(nd[7]);
    if (hit_box && leaf >= 0) {
      const Tile* tile = tile0 + static_cast<size_t>(leaf) * 16 * kLeaf;
      for (int k = 0; k < kLeaf; ++k) {
        float f[9];
        load_tri(tile, k, dq, f);
        const float v0x = f[0], v0y = f[1], v0z = f[2];
        const float e1x = f[3], e1y = f[4], e1z = f[5];
        const float e2x = f[6], e2y = f[7], e2z = f[8];
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
        const bool hit = det_ok && uu >= 0.0f && vv >= 0.0f &&
                         uu + vv <= 1.0f && tt > r.tmin &&
                         tt < fminf(b.t, r.tmax);
        if (hit) {
          if (kAnyHit) {
            b.blocked = true;
            return;
          }
          b.t = tt;
          b.row = row0 + leaf * kLeaf + k;
          b.u = uu;
          b.v = vv;
        }
      }
    }
    c = (hit_box && leaf < 0) ? c + 1 : skip;
  }
}

}  // namespace rptr_stream
