// The two-level walk of K6 (traverse_tlas.cu) and K7 (traverse_tlas_stream.cu)
// for Hopper: resumable per-lane walks whose entered leaves the whole warp
// tests together.
//
// Each lane walks one ray, as the plain versions do (ops/tlas.py::sweep,
// ops/traverse.py::walk_ranges): the top tree in preorder (K6's ordered mode:
// the next instance by (entry t, preorder index), next_ordered), entering a
// node when the slab test passes with t_far capped by the ray's best hit;
// at an entered instance or entry, the object ray (stream_walk.cuh::
// object_ray) and the walk of that BLAS or chunk subtree, its node skip
// links local, until it leaves past ``count``. The lane keeps its walk as
// state (Walk below: the top-tree cursor or the ordered walk's last pick,
// the object ray, the subtree cursor or "not in one", and its best t, row,
// u, v and instance), and one step (Walk::step) advances it to its next
// entered leaf, or to its end.
//
// The leaves are tested by the warp (test_leaves): after each step,
// __ballot_sync finds the lanes that hold a leaf, and the warp serves them
// in turn, lowest lane first. The owner's object ray, its segment [tmin,
// min(best t, tmax)] and its leaf's tile row go to every lane by
// __shfl_sync; lane j tests triangles 4j..4j+3 of the field-major tile
// (rows 0-8: v0, e1, e2 xyz of 128 triangles) with one 16-byte __ldg per
// row, so a leaf is 9 coalesced 512-byte loads; the Moller-Trumbore
// expressions are stream_walk.cuh::walk_subtree's (mt_hit). A
// __shfl_xor_sync reduction over (t, k) keeps the least t, then the least
// k, and the lane holding k hands its u, v to the owner, which takes the
// hit if it is strictly nearer than its best. Any-hit mode takes
// __any_sync instead. Lanes past n and lanes whose walk has ended stay in
// the loop and help until the ballot finds no leaf in the warp (a full-mask
// shuffle with an exited lane is undefined).
//
// Why this equals the plain walk bit for bit. The plain walk tests a leaf's
// triangles k = 0..127 in order and accepts a triangle when tt > tmin and
// tt < min(best, tmax), best falling with each accepted triangle. Whether a
// triangle is a candidate (det, u, v and tt > tmin) does not depend on best,
// and the leaf starts with best = the owner's best t before the leaf. So
// the last triangle the scan accepts is the first in k order of those with
// the least tt below min(best, tmax): every candidate with a smaller tt is
// accepted when its turn comes; one with the least tt is accepted unless an
// earlier one had the same tt (strict <), so the first of them wins and no
// later triangle beats it. The warp computes exactly that: every lane tests
// its 4 triangles against the same min(best, tmax) (the leaf's entry
// value), keeps its first least one, and the reduction orders (t, k) by t,
// then by k, with t and k moved together, so t keeps the winner's bits
// (+0 and -0 compare equal and fall to the lower k, as in the scan); u and
// v are the winner's. Each lane's walk visits its nodes and leaves in the
// plain order, and a leaf's result is applied before the lane steps again,
// so every slab test sees the best t the plain walk would. Across leaves
// and instances a hit must improve strictly: the first visited triangle
// keeps an exact-t tie, as in the plain version. K6's instance is the one
// whose leaf gave the last accepted hit, which is the plain version's
// "the walk of this instance lowered best".
//
// Node loads are 16-byte loads: a 32-byte node as two float4, from shared
// memory for a staged top tree (one block copies it in), else through the
// read-only path from global memory. The wrappers check that every base
// pointer read as float4 is 16-byte aligned (the packs keep every node and
// tile offset a multiple of 16 bytes).
//
// Built with --fmad=false and without fast math (kernels/build.py): every
// multiply and add rounds on its own, as in the plain version's tensor ops.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "stream_walk.cuh"

namespace rptr_tlas {

using rptr_stream::Best;
using rptr_stream::Ray;
using rptr_stream::kLeaf;

constexpr unsigned kFull = 0xffffffffu;
// the launch bound of K6 and K7; the launcher picks the block size up to it
constexpr int kMaxThreads = 512;
constexpr int kNoTri = 0x7fffffff;  // a leaf without a hit
constexpr int kRow4 = kLeaf / 4;    // float4s in one 128-float tile row

// A node's 8 floats (min3, max3, skip, payload) in two 16-byte loads: from
// shared memory, or (kGlobal) from global memory through the read-only path
template <bool kGlobal>
__device__ __forceinline__ void load_node(const float4* p, float (&nd)[8]) {
  float4 a, b;
  if (kGlobal) {
    a = __ldg(p);
    b = __ldg(p + 1);
  } else {
    a = p[0];
    b = p[1];
  }
  nd[0] = a.x; nd[1] = a.y; nd[2] = a.z; nd[3] = a.w;
  nd[4] = b.x; nd[5] = b.y; nd[6] = b.z; nd[7] = b.w;
}

// Every block copies the top tree (num_top nodes of 32 B) into its shared
// memory, 16 bytes a thread per step
__device__ __forceinline__ void stage_top(float4* dst,
                                          const float4* __restrict__ src,
                                          int num_top) {
  for (int j = threadIdx.x; j < 2 * num_top; j += blockDim.x) {
    dst[j] = __ldg(src + j);
  }
  __syncthreads();
}

// One pick of the ordered walk (K6): stream_walk.cuh::next_ordered with
// 16-byte node loads. The leaf with the least (entry t, preorder index)
// above (last_e, last_j) among the leaves the slab test enters with t_far
// capped at ``cap``; its preorder index (entry t in ``e``) or -1.
template <bool kGlobal>
__device__ int next_ordered(const float4* top, int num_top, const Ray& r,
                            float cap, float last_e, int last_j, float& e) {
  float ce = INFINITY;
  int cj = -1;
  int cur = 0;
  while (cur < num_top) {
    float nd[8];
    load_node<kGlobal>(top + 2 * cur, nd);
    float te;
    const bool hit_box = rptr_stream::slab_entry(nd, r, fminf(cap, ce), te);
    const int payload = static_cast<int>(nd[7]);
    if (hit_box && payload >= 0 && te < ce &&
        (te > last_e || (te == last_e && cur > last_j))) {
      ce = te;
      cj = cur;
    }
    cur = (hit_box && payload < 0) ? cur + 1 : static_cast<int>(nd[6]);
  }
  e = ce;
  return cj;
}

// An entered instance (K6) or (instance, chunk) entry (K7): its object ray,
// its subtree's nodes (node i at nodes[2i], nodes[2i + 1], local links, the
// walk leaving at ``count`` or past it), the tile row of its leaf 0 (leaf l
// at tile0 + 16 l, rows of 128 floats), the global row of leaf 0's first
// triangle (leaf l, triangle k: row0 + 128 l + k) and its id.
struct Sub {
  Ray o;
  const float4* nodes;
  int count, tile0, row0, id;
};

// Moller-Trumbore of the triangle f (v0, e1, e2 xyz) against the ray (o, d)
// in the expression order of stream_walk.cuh::walk_subtree (that of
// traverse_pallas2._mt_leaf): a hit when tt > tmin and tt < cap
__device__ __forceinline__ bool mt_hit(const float (&f)[9], float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float tmin, float cap, float& tt,
                                       float& uu, float& vv) {
  const float v0x = f[0], v0y = f[1], v0z = f[2];
  const float e1x = f[3], e1y = f[4], e1z = f[5];
  const float e2x = f[6], e2y = f[7], e2z = f[8];
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool det_ok = fabsf(det) > 1e-12f;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  vv = (dx * qx + dy * qy + dz * qz) * inv_det;
  tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin &&
         tt < cap;
}

__device__ __forceinline__ float lane_of(const float4& q, int s) {
  return s == 0 ? q.x : s == 1 ? q.y : s == 2 ? q.z : q.w;
}

// What a leaf gave its owner: the first least hit (k = kNoTri: none; in
// any-hit mode k = 0 marks a hit)
struct LeafHit {
  float t, u, v;
  int k;
};

// The warp tests the leaf of every lane in ``pend`` (a ballot), lowest
// lane first; each lane passes its object ray, its cap min(best t, tmax)
// and its leaf's tile row, which only count where the lane is in ``pend``.
// Every lane of the warp must call it. Returns this lane's own result.
template <bool kAnyHit>
__device__ __forceinline__ LeafHit test_leaves(unsigned pend,
                                               const float* __restrict__ tiles,
                                               const Ray& o, float cap,
                                               int tile_row) {
  const int lane = threadIdx.x & 31;
  LeafHit mine{0.0f, 0.0f, 0.0f, kNoTri};
  while (pend) {
    const int src = __ffs(pend) - 1;
    pend &= pend - 1;
    const float ox = __shfl_sync(kFull, o.ox, src);
    const float oy = __shfl_sync(kFull, o.oy, src);
    const float oz = __shfl_sync(kFull, o.oz, src);
    const float dx = __shfl_sync(kFull, o.dx, src);
    const float dy = __shfl_sync(kFull, o.dy, src);
    const float dz = __shfl_sync(kFull, o.dz, src);
    const float tmin = __shfl_sync(kFull, o.tmin, src);
    const float tcap = __shfl_sync(kFull, cap, src);
    const int row = __shfl_sync(kFull, tile_row, src);
    const float4* p = reinterpret_cast<const float4*>(
                          tiles + static_cast<size_t>(row) * kLeaf) + lane;
    float4 q[9];
#pragma unroll
    for (int f = 0; f < 9; ++f) q[f] = __ldg(p + f * kRow4);
    // this lane's 4 triangles in k order: the first least hit
    float bt = INFINITY, bu = 0.0f, bv = 0.0f;
    int bk = kNoTri;
    bool any = false;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float f[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) f[j] = lane_of(q[j], s);
      float tt, uu, vv;
      const bool hit =
          mt_hit(f, ox, oy, oz, dx, dy, dz, tmin, tcap, tt, uu, vv);
      if (kAnyHit) {
        any = any || hit;
      } else if (hit && tt < bt) {
        bt = tt;
        bu = uu;
        bv = vv;
        bk = 4 * lane + s;
      }
    }
    if (kAnyHit) {
      if (__any_sync(kFull, any) && lane == src) mine.k = 0;
      continue;
    }
    // the least (t, k) over the warp, t and k moved together
    float t = bt;
    int k = bk;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, t, off);
      const int ok = __shfl_xor_sync(kFull, k, off);
      if (ot < t || (ot == t && ok < k)) {
        t = ot;
        k = ok;
      }
    }
    if (k == kNoTri) continue;  // the same on every lane
    // lane k / 4 holds triangle k's u, v: its own first least hit is k
    const float u = __shfl_sync(kFull, bu, k >> 2);
    const float v = __shfl_sync(kFull, bv, k >> 2);
    if (lane == src) mine = LeafHit{t, u, v, k};
  }
  return mine;
}

// One lane's resumable two-level walk. ``Scene`` enters an instance or
// entry: ``Sub enter(int id, const Ray& r) const``.
template <bool kAnyHit, bool kOrdered, bool kGlobal, class Scene>
struct Walk {
  const float4* top;  // the top tree, staged or global
  int num_top;
  Ray r;              // the world ray
  Best b;
  int winner = -1;    // K6: the instance of the best hit
  bool done;
  bool in_sub = false;
  Sub s;
  int c = 0;          // the subtree cursor
  int cur = 0;        // the top-tree cursor (preorder)
  float last_e = -INFINITY;  // the ordered walk's last pick
  int last_j = -1;
  int tile_row = 0, leaf_row = 0;  // the leaf this lane holds

  // ``live``: a ray to walk (an empty segment, tmax <= tmin, never hits,
  // and lanes past n hold no ray)
  __device__ Walk(const float4* top_, int num_top_, const Ray& r_, bool live)
      : top(top_), num_top(num_top_), r(r_),
        b{r_.tmax, -1, 0.0f, 0.0f, false}, done(!live) {
    s.o = r_;
    s.nodes = nullptr;
    s.count = s.tile0 = s.row0 = 0;
    s.id = -1;
  }

  // Advance to the next entered leaf (true) or to the walk's end (false)
  __device__ __forceinline__ bool step(const Scene& scene) {
    while (!done) {
      if (in_sub) {
        while (c < s.count) {
          float nd[8];
          load_node<true>(s.nodes + 2 * c, nd);
          const bool hit_box = rptr_stream::slab(nd, s.o, b.t);
          const int skip = static_cast<int>(nd[6]);
          const int leaf = static_cast<int>(nd[7]);
          c = (hit_box && leaf < 0) ? c + 1 : skip;
          if (hit_box && leaf >= 0) {
            tile_row = s.tile0 + leaf * 16;
            leaf_row = s.row0 + leaf * kLeaf;
            return true;
          }
        }
        in_sub = false;
      }
      int id = -1;
      if (kOrdered) {
        float e;
        const int j = next_ordered<kGlobal>(top, num_top, r, b.t, last_e,
                                            last_j, e);
        if (j >= 0) {
          float nd[8];
          load_node<kGlobal>(top + 2 * j, nd);
          id = static_cast<int>(nd[7]);
          last_e = e;
          last_j = j;
        }
      } else {
        while (cur < num_top) {
          float nd[8];
          load_node<kGlobal>(top + 2 * cur, nd);
          const bool hit_box = rptr_stream::slab(nd, r, b.t);
          const int payload = static_cast<int>(nd[7]);
          cur = (hit_box && payload < 0) ? cur + 1 : static_cast<int>(nd[6]);
          if (hit_box && payload >= 0) {
            id = payload;
            break;
          }
        }
      }
      if (id < 0) {
        done = true;
      } else {
        s = scene.enter(id, r);
        c = 0;
        in_sub = true;
      }
    }
    return false;
  }

  // Step every lane and test the warp's leaves until no lane holds one
  __device__ __forceinline__ void run(const Scene& scene,
                                      const float* __restrict__ tiles) {
    for (;;) {
      const bool pending = step(scene);
      const unsigned pend = __ballot_sync(kFull, pending);
      if (pend == 0) return;
      const LeafHit h = test_leaves<kAnyHit>(pend, tiles, s.o,
                                             fminf(b.t, s.o.tmax), tile_row);
      if (!pending || h.k == kNoTri) continue;
      if (kAnyHit) {
        b.blocked = true;
        done = true;
      } else if (h.t < b.t) {
        b.t = h.t;
        b.row = leaf_row + h.k;
        b.u = h.u;
        b.v = h.v;
        winner = s.id;
      }
    }
  }
};

}  // namespace rptr_tlas
