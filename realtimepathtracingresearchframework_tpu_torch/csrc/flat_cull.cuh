// The flat cull: the per-lane slab test of a leaf box that K2
// (traverse_flat_cull.cu) and K3 (traverse_precull.cu) both run, and K2's
// broad phase: a group's packet bounds, its interval test against every
// leaf box, and the sort of the surviving leaves by their entry bound. The
// leaves that survive are tested by tlas_walk.cuh's warp-shared leaf test
// (serve_leaves).
//
// The entry bound ``lb`` of a surviving leaf (the interval test's lower
// end) is a lower bound on the slab entry t of every live lane of the
// group (enters below), and every leaf a live lane enters survives. A
// lane's entry is max(tmin, its three axes' tsmall), each from slab_axis.
// On an axis where no live lane of the group has a zero direction
// component, the lane's fl(fl(lo - o) * i) lies between the rounded corner
// products fl(a * i') of the group's intervals a in [fl(lo - ohi),
// fl(lo - olo)], i' in [ilo, ihi], because rounding is monotone and a
// product is monotone in each factor; so the lane's min(t0, t1) is at
// least the interval's min(t0lo, t1lo) and its max(t0, t1) at most the
// interval's max(t0hi, t1hi). On an axis where some live lane has a zero
// component, that lane's slab is the whole line or empty, and the other
// lanes' products still lie in the intervals, so the union over the
// group's lanes is bounded by nothing there: the test skips that axis
// (the group's rows 14-16), bounding lb by -inf and the upper end by +inf.
// Either way each axis's lower end is at most every lane's tsmall on it
// and each upper end at least every lane's tbig, the lane's tmin is at
// least the group's, so its entry is at least lb, and a lane that enters
// the box (entry <= exit) makes lb <= ub. The distance test max(alo, -bhi)
// <= thi holds for a lane that enters with |d| <= 1 and is skipped with
// its axis. A lane whose best t is below a leaf's lb cannot enter that
// leaf, nor any leaf sorted after it (tests/test_torch_flat_cull.py holds
// both properties on the CPU, on the axis-aligned queue too).
//
// Built with --fmad=false and without fast math (kernels/build.py): every
// multiply and add rounds on its own, as in the plain version's tensor ops.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_walk.cuh"  // Ray

namespace rptr_flat {

using rptr_stream::Ray;
using rptr_stream::slab_axis;

constexpr float kBig = 3.0e38f;  // empty box / dead-lane fill
constexpr int kBoundsN = 17;     // the packet bounds of traverse_flat.group_bounds

// ray_leaf_hits' slab test of leaf l's box (aabbs (16, lpad): rows 0-2
// min, 3-5 max) on the segment [tmin, tcap], each axis by slab_axis
__device__ __forceinline__ bool enters(const float* __restrict__ aabbs,
                                       int lpad, int l, const Ray& r,
                                       float tcap) {
  const float lox = __ldg(aabbs + l), hix = __ldg(aabbs + 3 * lpad + l);
  const float loy = __ldg(aabbs + lpad + l), hiy = __ldg(aabbs + 4 * lpad + l);
  const float loz = __ldg(aabbs + 2 * lpad + l), hiz = __ldg(aabbs + 5 * lpad + l);
  // an empty padding box (lo > hi) is refused by its last test
  float tn = r.tmin, tf = tcap, s, b;
  slab_axis(lox, hix, r.ox, r.ix, s, b);
  tn = fmaxf(tn, s);
  tf = fminf(tf, b);
  slab_axis(loy, hiy, r.oy, r.iy, s, b);
  tn = fmaxf(tn, s);
  tf = fminf(tf, b);
  slab_axis(loz, hiz, r.oz, r.iz, s, b);
  tn = fmaxf(tn, s);
  tf = fminf(tf, b);
  return tn <= tf && lox <= hix;
}

// The segment end a lane's slab test of a leaf box takes while it walks:
// its best t so far, raised by 2^-20 of itself. Moller-Trumbore and the
// slab test round apart, so a hit on a box's face can lie an ulp or a few
// before the box's f32 entry t; a test capped at the best t alone would
// then reject the leaf of a hit that ties the best t from a lower row, or
// beats it by an ulp, and the plain version (each lane's slab test of its
// whole segment, then the (t, row) merge) keeps that hit. The MT tests
// themselves stay capped at the best t, strictly.
__device__ __forceinline__ float leaf_cap(float t) {
  return t + fabsf(t) * 0x1p-20f;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Whether bound k of the packet (group_bounds order: 0-2 origin min, 3-5
// origin max, 6-8 inv-dir min, 9-11 inv-dir max, 12 tmin min, 13 tmax
// max, 14-16 a live lane's zero direction component per axis) is a minimum
__device__ __forceinline__ bool is_min(int k) {
  return k < 3 || (k >= 6 && k < 9) || k == 12;
}

// The warp's share of its group's packet bounds over its live lanes, on
// every lane; min and max are exact in any order
__device__ __forceinline__ void warp_bounds(const Ray& r, bool live,
                                            float (&v)[kBoundsN]) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  const float iv[3] = {r.ix, r.iy, r.iz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = warp_min(live ? o[k] : kBig);
    v[3 + k] = warp_max(live ? o[k] : -kBig);
    // +inf on a zero component: its axis is skipped (rows 14-16)
    v[6 + k] = warp_min(live ? iv[k] : kBig);
    v[9 + k] = warp_max(live ? iv[k] : -kBig);
    v[14 + k] = warp_max(live && d[k] == 0.0f ? 1.0f : 0.0f);
  }
  v[12] = warp_min(live ? r.tmin : kBig);
  v[13] = warp_max(live ? r.tmax : -kBig);
}

// The interval test of traverse_pallas3.py:187-226 of the packet ``pb``
// against leaf l's box: whether the leaf survives, and its entry bound lb.
// An axis on which a live lane has a zero direction component bounds
// nothing (that lane's slab is the whole line there)
__device__ __forceinline__ bool survives(const float (&pb)[kBoundsN],
                                         const float* __restrict__ aabbs,
                                         int lpad, int l, float& lb) {
  const float tlo = pb[12], thi = pb[13];
  float ub = thi;
  lb = tlo;
  bool expand_ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (pb[14 + k] > 0.0f) continue;
    const float olo = pb[k], ohi = pb[3 + k];
    const float ilo = pb[6 + k], ihi = pb[9 + k];
    const float bmn = __ldg(aabbs + k * lpad + l);
    const float bmx = __ldg(aabbs + (3 + k) * lpad + l);
    const float alo = bmn - ohi, ahi = bmn - olo;
    const float blo = bmx - ohi, bhi = bmx - olo;
    const float t0lo = fminf(fminf(alo * ilo, alo * ihi), fminf(ahi * ilo, ahi * ihi));
    const float t0hi = fmaxf(fmaxf(alo * ilo, alo * ihi), fmaxf(ahi * ilo, ahi * ihi));
    const float t1lo = fminf(fminf(blo * ilo, blo * ihi), fminf(bhi * ilo, bhi * ihi));
    const float t1hi = fmaxf(fmaxf(blo * ilo, blo * ihi), fmaxf(bhi * ilo, bhi * ihi));
    lb = fmaxf(lb, fminf(t0lo, t1lo));
    ub = fminf(ub, fmaxf(t0hi, t1hi));
    expand_ok = expand_ok && (fmaxf(alo, -bhi) <= thi);
  }
  return lb <= ub && expand_ok;
}

// A survivor's sort key: lb's bits mapped to an unsigned order (negative
// floats flipped whole, the others' sign bit set), then the leaf index, so
// keys ascend by (lb, leaf) and no two are equal
__device__ __forceinline__ unsigned long long leaf_key(float lb, int leaf) {
  unsigned u = __float_as_uint(lb);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(leaf);
}

__device__ __forceinline__ float key_lb(unsigned long long key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_leaf(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key));
}

// Sort keys[0, count) ascending in shared memory, by the block's threads
// (one barrier per step). A bitonic network in which every comparator puts
// the smaller key at the lower index (each merge's first step compares
// mirrored indices): the positions past ``count`` stand for keys above all
// others, and such a comparator never moves them, so they are skipped and
// the list needs no padding.
__device__ __forceinline__ void sort_keys(unsigned long long* keys, int count) {
  int p = 1;
  while (p < count) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int s = threadIdx.x; s < (p >> 1); s += blockDim.x) {
        const int blk = s / j, off = s % j;
        int a, b;
        if (j == (k >> 1)) {  // the mirror step of a merge of size k
          a = blk * k + off;
          b = blk * k + k - 1 - off;
        } else {
          a = blk * 2 * j + off;
          b = a + j;
        }
        if (b < count) {
          const unsigned long long x = keys[a], y = keys[b];
          if (y < x) {
            keys[a] = y;
            keys[b] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace rptr_flat
