// The walks of K1 (traverse_resident.cu), K4 (traverse_streamed.cu), K5
// (traverse_binned.cu), K6 (traverse_tlas.cu), K7 (traverse_tlas_stream.cu),
// K8a and K8b (traverse_v1.cu) for Hopper, and the leaf test K3
// (traverse_precull.cu)
// shares with them: resumable per-lane walks whose entered leaves the whole
// warp tests together.
//
// Each lane walks one ray, as the plain versions do (ops/tlas.py::sweep,
// ops/traverse.py::walk_ranges, traverse_stream.plain): the top tree in
// preorder (the ordered modes of K4 and K6: the next subtree or instance by
// (entry t, preorder index), next_ordered), entering a node when the slab
// test passes with t_far capped by the ray's best hit; at an entered
// subtree, instance or entry, its ray (K4: the world ray; K6, K7: the
// object ray, stream_walk.cuh::object_ray) and the walk of that subtree,
// BLAS or chunk subtree, its node skip links local, until it leaves past
// ``count``. The lane keeps its walk as state (Walk below: the top-tree
// cursor or the ordered walk's last pick, the subtree's ray, the subtree
// cursor or "not in one", and its best t, row, u, v and instance), and one
// step (Walk::step) advances it to its next entered leaf, or to its end.
// K5 enters its bin's one subtree directly with a seeded best (Walk's
// second constructor; the subtree's node block staged in shared memory,
// kSubGlobal = false) and ends when it leaves it. K1, K8a and K8b walk one
// threaded BVH of two tables (Threaded: bounds (M, 6), links (M, 2)) with
// LaneWalk, and stop each leaf at its real-row count (walk_threaded below).
//
// The leaves are tested by the warp (test_leaves): after each step,
// __ballot_sync finds the lanes that hold a leaf, and the warp serves them
// in turn, lowest lane first. The owner's object ray, its segment [tmin,
// min(best t, tmax)] and its leaf's tile row go to every lane by
// __shfl_sync; lane j tests triangles 4j..4j+3 of the field-major tile
// (rows 0-8: v0, e1, e2 xyz of 128 triangles) with one 16-byte __ldg per
// row, so a leaf is 9 coalesced 512-byte loads (FieldTiles; QuantTiles
// decodes K4's and K5's 16-bit tiles from 8-byte loads, RowTiles reads
// K1's and K3's row-major leaves of 32, 64 or 128 rows, ColumnTiles K8b's
// (16, Rp) table, WideRows K8a's (Rp, 16) one); the Moller-Trumbore
// expressions are those of
// traverse_pallas2._mt_leaf (mt_hit). A
// __shfl_xor_sync reduction over (t, k) keeps the least t, then the least
// k, and the lane holding k hands its u, v to the owner, which takes the
// hit if it is strictly nearer than its best. Any-hit mode takes
// __any_sync instead. Lanes past n and lanes whose walk has ended stay in
// the loop and help until the ballot finds no leaf in the warp (a full-mask
// shuffle with an exited lane is undefined). K1, K3, K5, K8a and K8b serve a
// leaf by its number of holders (serve_leaves): one that ``scan_from`` or more
// lanes hold (a coherent queue) is scanned by each holder itself in k order
// (scan_leaf: every holder reads the same address, a broadcast), which
// keeps the same first least hit, and any other through test_leaves.
//
// The counted forms (kCounted, used by walk_threaded: K1, K8a, K8b) stop a
// leaf at its real-row count: a pack pads a leaf by repeating its last
// triangle, and a row equal bit for bit to an earlier row of its leaf
// cannot change a result (the scan tested the earlier row first under a cap
// at least as large, the warp's (t, k) reduction keeps the lower k on a
// tie, and any-hit has stopped at the earlier row), so the result stays
// the plain versions' (ops/traverse.py::real_row_counts). The holders'
// scan stops there: cornell's one leaf of 32 triangles in 128 rows (K8a) is
// scanned in 8 steps, not 32. The warp's test of a leaf of 128 rows in a
// row-major table (K8a's WideRows, K1's RowTiles<128>: Tiles::kStrided)
// takes its rows strided, lane j triangles j, j + 32, ... below the count
// (one load1 each), so a leaf of c real rows costs ceil(c / 32)
// Moller-Trumbore steps, not 4: the terrains' leaves of 128 rows hold
// 56-126 real ones. Elsewhere the warp tests every row, as the uncounted
// form does: a leaf of 32 rows is one step a lane either way, and K8b's
// field-major table and leaves of 64 rows were measured faster so (PERF.md);
// the result is the same.
//
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "stream_walk.cuh"

namespace rptr_tlas {

using rptr_stream::Best;
using rptr_stream::Ray;
using rptr_stream::kLeaf;

constexpr unsigned kFull = 0xffffffffu;
// the launch bound of K3, K6 and K7; the launcher picks the block size up
// to it
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

// One pick of the ordered walk (K4, K6) over a top tree of num_top nodes
// (min3, max3, skip, payload or -1): the leaf with the least (entry t,
// preorder index) above (last_e, last_j) among the leaves the slab test
// enters with t_far capped at ``cap`` (the ray's best t so far); its
// preorder index (entry t in ``e``), or -1 when none is left. A subtree
// whose box is entered later than the best candidate so far cannot hold a
// better one, so the scan caps t_far at that candidate's entry too. Node
// boxes contain their children's, so a leaf is found exactly where its own
// slab test passes: the plain versions (ops/tlas.py::ordered_sweep,
// traverse_stream.plain_ordered) compare the leaves' entries directly. Per
// ray, two registers and no candidate list.
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

// An entered subtree (K4), instance (K6) or (instance, chunk) entry (K7):
// its ray (K4: the world ray; K6, K7: the object ray), its subtree's nodes
// (node i at nodes[2i], nodes[2i + 1], local links, the walk leaving at
// ``count`` or past it), the tile row of its leaf 0 (leaf l at tile0 + 16 l,
// rows of 128 floats), the global row of leaf 0's first triangle (leaf l,
// triangle k: row0 + 128 l + k) and its id.
struct Sub {
  Ray o;
  const float4* nodes;
  int count, tile0, row0, id;
};

// Moller-Trumbore of the triangle f (v0, e1, e2 xyz) against the ray (o, d)
// in the expression order of traverse_pallas2._mt_leaf (that of the plain
// versions' ops/traverse.py::_mt_rows): a hit when tt > tmin and tt < cap
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

// The leaf loaders of test_leaves. Each gives lane ``lane`` its kPerLane
// triangles kPerLane * lane .. kPerLane * lane + kPerLane - 1 of the leaf
// ``leaf`` (9 floats each: v0, e1, e2 xyz), from one coalesced load per
// field row or triangle run.

// Field-major f32 tiles (K4, K6, K7): ``leaf`` is the tile row of its first
// field; row f holds field f of the leaf's 128 triangles, so a leaf is 9
// coalesced 512-byte loads, 16 bytes a lane.
struct FieldTiles {
  static constexpr int kPerLane = 4;
  static constexpr bool kStrided = false;
  const float* __restrict__ tiles;

  __device__ __forceinline__ void load(int leaf, int lane,
                                       float (&f)[4][9]) const {
    const float4* p = reinterpret_cast<const float4*>(
                          tiles + static_cast<size_t>(leaf) * kLeaf) + lane;
    float4 q[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) q[j] = __ldg(p + j * kRow4);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int j = 0; j < 9; ++j) f[s][j] = lane_of(q[j], s);
    }
  }
};

// Field-major 16-bit tiles of a quantized streamed pack (K4, K5): int16
// codes offset by -32768 (rows 0-8: q0, q1, q2 xyz), 9 coalesced 256-byte
// loads, 8 bytes a lane, decoded in traverse_stream.dequant_tile's
// expression order (int16 -> int -> float, never through float bit
// patterns; v0 = c + (q0 + 32768) * s, edges (qk - q0) * s), so a decoded
// triangle is bitwise traverse_stream.reconstruct_quantized's, with the
// grid min c and scale s of the leaf's subtree: the first six floats of the
// last slot of its node block, which no walk lands on. Subtree s owns the
// tile rows [s * rows_per_sub, (s + 1) * rows_per_sub), so the leaf's row
// names it.
struct QuantTiles {
  static constexpr int kPerLane = 4;
  static constexpr bool kStrided = false;
  const int16_t* __restrict__ tiles;
  const float* __restrict__ sub_nodes;
  int rows_per_sub, slots;

  __device__ __forceinline__ void load(int leaf, int lane,
                                       float (&f)[4][9]) const {
    const int sid = leaf / rows_per_sub;
    const float4* g = reinterpret_cast<const float4*>(
        sub_nodes + (static_cast<size_t>(sid) * slots + slots - 1) * 8);
    const float4 g0 = __ldg(g), g1 = __ldg(g + 1);
    const float c[3] = {g0.x, g0.y, g0.z};
    const float sc[3] = {g0.w, g1.x, g1.y};
    const short4* p = reinterpret_cast<const short4*>(
                          tiles + static_cast<size_t>(leaf) * kLeaf) + lane;
    float q[9][4];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const short4 w = __ldg(p + j * (kLeaf / 4));
      q[j][0] = static_cast<float>(static_cast<int>(w.x));
      q[j][1] = static_cast<float>(static_cast<int>(w.y));
      q[j][2] = static_cast<float>(static_cast<int>(w.z));
      q[j][3] = static_cast<float>(static_cast<int>(w.w));
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        f[s][a] = c[a] + (q[a][s] + 32768.0f) * sc[a];
        f[s][3 + a] = (q[3 + a][s] - q[a][s]) * sc[a];
        f[s][6 + a] = (q[6 + a][s] - q[a][s]) * sc[a];
      }
    }
  }
};

// Row-major (R, 9) rows of a flat BVH with leaves of kLS rows (K3): ``leaf``
// is the leaf index, leaf l owns rows [l * kLS, (l + 1) * kLS). A lane's
// kLS / 32 triangles are 9 * kLS / 32 contiguous floats: 9 aligned loads of
// 16 bytes at kLS = 128, of 8 bytes at 64, of 4 bytes at 32.
template <int kLS>
struct RowTiles {
  static_assert(kLS == 32 || kLS == 64 || kLS == 128, "leaf size");
  static constexpr int kPerLane = kLS / 32;
  // the counted warp test takes a leaf of 128 rows strided (test_leaves)
  static constexpr bool kStrided = kLS == 128;
  const float* __restrict__ rows;

  // the handle is the leaf index
  static __device__ __forceinline__ int row0(int leaf) { return leaf * kLS; }
  static __device__ __forceinline__ int leaf_index(int leaf) { return leaf; }

  // triangle k of the leaf alone (the counted warp test)
  __device__ __forceinline__ void load1(int leaf, int k, float (&f)[9]) const {
    const float* p = rows + (static_cast<size_t>(leaf) * kLS + k) * 9;
#pragma unroll
    for (int j = 0; j < 9; ++j) f[j] = __ldg(p + j);
  }

  __device__ __forceinline__ void load(int leaf, int lane,
                                       float (&f)[kPerLane][9]) const {
    const float* p =
        rows + (static_cast<size_t>(leaf) * kLS + kPerLane * lane) * 9;
    float a[9 * kPerLane];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if constexpr (kPerLane == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p) + j);
        a[4 * j] = v.x; a[4 * j + 1] = v.y; a[4 * j + 2] = v.z;
        a[4 * j + 3] = v.w;
      } else if constexpr (kPerLane == 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p) + j);
        a[2 * j] = v.x; a[2 * j + 1] = v.y;
      } else {
        a[j] = __ldg(p + j);
      }
    }
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) {
#pragma unroll
      for (int j = 0; j < 9; ++j) f[s][j] = a[9 * s + j];
    }
  }
};

// The field-major (16, Rp) triangle table of the v1 walk (K8b): ``leaf``
// is the leaf's first row; row f holds field f of every triangle, so the
// leaf's field f is 128 contiguous floats at f * rp + leaf: 9 coalesced
// 512-byte loads, 16 bytes a lane. Rp and every leaf's first row are
// multiples of 128, and the wrapper checks the table's 16-byte alignment.
struct ColumnTiles {
  static constexpr int kPerLane = 4;
  // the warp test keeps its coalesced 16-byte loads (test_leaves)
  static constexpr bool kStrided = false;
  const float* __restrict__ tris;
  int rp;

  // the handle is the leaf's first row
  static __device__ __forceinline__ int row0(int leaf) { return leaf; }
  static __device__ __forceinline__ int leaf_index(int leaf) {
    return leaf / kLeaf;
  }

  __device__ __forceinline__ void load(int leaf, int lane,
                                       float (&f)[4][9]) const {
    const float* p = tris + leaf + 4 * lane;
    float4 q[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      q[j] = __ldg(reinterpret_cast<const float4*>(
          p + static_cast<size_t>(j) * rp));
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int j = 0; j < 9; ++j) f[s][j] = lane_of(q[j], s);
    }
  }
};

// The row-major (Rp, 16) triangle table of the v1 walk (K8a): ``leaf`` is
// the leaf's first row; a row is 64 bytes (v0, e1, e2, then 7 unused
// floats), so lane j's triangles 4j..4j+3 are four rows, each read with two
// 16-byte loads and one 4-byte load. Every leaf's first row is a multiple
// of 128, and the wrapper checks the table's 16-byte alignment.
struct WideRows {
  static constexpr int kPerLane = 4;
  static constexpr bool kStrided = true;
  const float* __restrict__ tris;

  static __device__ __forceinline__ int row0(int leaf) { return leaf; }
  static __device__ __forceinline__ int leaf_index(int leaf) {
    return leaf / kLeaf;
  }

  // triangle k of the leaf alone (the counted warp test)
  __device__ __forceinline__ void load1(int leaf, int k, float (&f)[9]) const {
    const float4* p = reinterpret_cast<const float4*>(
        tris + static_cast<size_t>(leaf + k) * 16);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    f[8] = __ldg(reinterpret_cast<const float*>(p + 2));
  }

  __device__ __forceinline__ void load(int leaf, int lane,
                                       float (&f)[4][9]) const {
    const float4* p = reinterpret_cast<const float4*>(
        tris + static_cast<size_t>(leaf + 4 * lane) * 16);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 a = __ldg(p + 4 * s), b = __ldg(p + 4 * s + 1);
      f[s][0] = a.x; f[s][1] = a.y; f[s][2] = a.z; f[s][3] = a.w;
      f[s][4] = b.x; f[s][5] = b.y; f[s][6] = b.z; f[s][7] = b.w;
      f[s][8] = __ldg(reinterpret_cast<const float*>(p + 4 * s + 2));
    }
  }
};

// What a leaf gave its owner: the first least hit (k = kNoTri: none; in
// any-hit mode k = 0 marks a hit)
struct LeafHit {
  float t, u, v;
  int k;
};

// The warp tests the leaf of every lane in ``pend`` (a ballot), lowest
// lane first; each lane passes its (object) ray, its cap min(best t, tmax)
// and its leaf (``Tiles``' handle: a tile row, or a leaf index), and
// (kCounted) the leaf's real-row count ``rows``, which only count where the
// lane is in ``pend``. Lane j tests the leaf's triangles Tiles::kPerLane * j
// onwards (kCounted with a Tiles::kStrided loader: triangles j, j + 32, ...
// below ``rows``, each from Tiles::load1). Every lane of the warp must call
// it. Returns this lane's own result.
template <bool kAnyHit, class Tiles, bool kCounted = false>
__device__ __forceinline__ LeafHit test_leaves(unsigned pend,
                                               const Tiles& tiles,
                                               const Ray& o, float cap,
                                               int leaf, int rows = 0) {
  constexpr int kPer = Tiles::kPerLane;
  constexpr int kShift = kPer == 4 ? 2 : kPer == 2 ? 1 : 0;
  constexpr bool kStrided = kCounted && Tiles::kStrided;
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
    const int row = __shfl_sync(kFull, leaf, src);
    int nrows = 0;
    if constexpr (kStrided) nrows = __shfl_sync(kFull, rows, src);
    // this lane's triangles in k order: the first least hit
    float bt = INFINITY, bu = 0.0f, bv = 0.0f;
    int bk = kNoTri;
    bool any = false;
    if constexpr (kStrided) {
      for (int k = lane; k < nrows; k += 32) {
        float f[9];
        tiles.load1(row, k, f);
        float tt, uu, vv;
        const bool hit =
            mt_hit(f, ox, oy, oz, dx, dy, dz, tmin, tcap, tt, uu, vv);
        if (kAnyHit) {
          any = any || hit;
        } else if (hit && tt < bt) {
          bt = tt;
          bu = uu;
          bv = vv;
          bk = k;
        }
      }
    } else {
      float f[kPer][9];
      tiles.load(row, lane, f);
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        float tt, uu, vv;
        const bool hit =
            mt_hit(f[s], ox, oy, oz, dx, dy, dz, tmin, tcap, tt, uu, vv);
        if (kAnyHit) {
          any = any || hit;
        } else if (hit && tt < bt) {
          bt = tt;
          bu = uu;
          bv = vv;
          bk = kPer * lane + s;
        }
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
    // lane k / kPer (strided: k % 32) holds triangle k's u, v: its own
    // first least hit is k
    const int holder = kStrided ? k & 31 : k >> kShift;
    const float u = __shfl_sync(kFull, bu, holder);
    const float v = __shfl_sync(kFull, bv, holder);
    if (lane == src) mine = LeafHit{t, u, v, k};
  }
  return mine;
}

// One lane tests the leaf ``leaf`` (Tiles' handle) itself, in k order
// against its falling best (the plain scan), Tiles::kPerLane triangles per
// load (those of lane j of test_leaves, j = 0..31; kCounted: up to the
// real-row count ``rows``); triangle k is global row row0 + k. Any-hit mode
// sets b.blocked at the first hit.
template <bool kAnyHit, class Tiles, bool kCounted = false>
__device__ __forceinline__ void scan_leaf(const Tiles& tiles, int leaf,
                                          int row0, const Ray& r, Best& b,
                                          int rows = 0) {
  constexpr int kPer = Tiles::kPerLane;
  const int groups = kCounted ? (rows + kPer - 1) / kPer : 32;
  for (int j = 0; j < groups; ++j) {
    float f[kPer][9];
    tiles.load(leaf, j, f);
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      if (kCounted && kPer * j + s >= rows) break;
      float tt, uu, vv;
      if (mt_hit(f[s], r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmin,
                 fminf(b.t, r.tmax), tt, uu, vv)) {
        if (kAnyHit) {
          b.blocked = true;
          return;
        }
        b.t = tt;
        b.row = row0 + kPer * j + s;
        b.u = uu;
        b.v = vv;
      }
    }
  }
}

// The warp serves the leaves of the lanes in ``pend`` (a ballot of
// ``pending``), each lane's leaf ``leaf`` (Tiles' handle; its triangle k
// is row row0 + k) tested against its ray ``r`` and best ``b``, and applies
// each result to its owner's b (a strictly nearer hit; any-hit: blocked).
// A leaf that ``scan_from`` or more lanes hold (grouped by handle with
// __match_any_sync) is scanned by each holder alone (scan_leaf), every
// other one by the whole warp (test_leaves); both keep the leaf's first
// least hit, so the result does not depend on ``scan_from`` (> 32: the
// warp serves every leaf). kCounted: each leaf's real-row count is at
// counts[Tiles::leaf_index(leaf)], where the scan stops, and the warp's
// test with a Tiles::kStrided loader; a lane loads it only where one of the
// two reads it. Every lane of the warp must call it.
template <bool kAnyHit, class Tiles, bool kCounted = false>
__device__ __forceinline__ void serve_leaves(bool pending, unsigned pend,
                                             const Tiles& tiles, const Ray& r,
                                             int leaf, int row0,
                                             int scan_from, Best& b,
                                             const int* __restrict__ counts =
                                                 nullptr) {
  bool scan = false;
  if (scan_from <= 32) {  // uniform over the warp
    const unsigned peers = __match_any_sync(kFull, pending ? leaf : -1);
    scan = pending && __popc(peers) >= scan_from;
  }
  int rows = 0;
  if constexpr (kCounted) {
    if (pending && (scan || Tiles::kStrided)) {
      rows = __ldg(counts + Tiles::leaf_index(leaf));
    }
  }
  const unsigned served = pend & ~__ballot_sync(kFull, scan);
  const LeafHit h = test_leaves<kAnyHit, Tiles, kCounted>(
      served, tiles, r, fminf(b.t, r.tmax), leaf, rows);
  if (scan) {
    scan_leaf<kAnyHit, Tiles, kCounted>(tiles, leaf, row0, r, b, rows);
  } else if (pending && h.k != kNoTri) {
    if (kAnyHit) {
      b.blocked = true;
    } else if (h.t < b.t) {
      b.t = h.t;
      b.row = row0 + h.k;
      b.u = h.u;
      b.v = h.v;
    }
  }
}

// Enters subtree sid of a streamed pack (K4, K5) with the world ray: its
// node block (slots nodes of 8 floats), its first tile row and its first
// global row
struct Subtrees {
  const float4* sub_nodes;
  int slots, sub_leaves;

  __device__ __forceinline__ Sub enter(int sid, const Ray& r) const {
    Sub s;
    s.o = r;
    s.nodes = sub_nodes + static_cast<size_t>(sid) * slots * 2;
    s.count = slots;
    s.tile0 = sid * sub_leaves * 16;
    s.row0 = sid * sub_leaves * kLeaf;
    s.id = sid;
    return s;
  }
};

// One lane's resumable two-level walk. ``Scene`` enters a subtree, an
// instance or an entry: ``Sub enter(int id, const Ray& r) const``.
// kGlobal: the top tree is read from global memory (else shared);
// kSubGlobal: the subtrees' nodes likewise.
template <bool kAnyHit, bool kOrdered, bool kGlobal, class Scene,
          bool kSubGlobal = true>
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

  // A walk of the one subtree ``sub`` from a seeded best (K5): no top tree,
  // so it ends when it leaves the subtree
  __device__ Walk(const Sub& sub, const Best& seed, bool live)
      : top(nullptr), num_top(0), r(sub.o), b(seed), done(!live),
        in_sub(live), s(sub) {}

  // Advance to the next entered leaf (true) or to the walk's end (false)
  __device__ __forceinline__ bool step(const Scene& scene) {
    while (!done) {
      if (in_sub) {
        while (c < s.count) {
          float nd[8];
          load_node<kSubGlobal>(s.nodes + 2 * c, nd);
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
  template <class Tiles>
  __device__ __forceinline__ void run(const Scene& scene,
                                      const Tiles& tiles) {
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

// A threaded BVH of two tables, as K1 and the v1 walk (K8a, K8b) read it:
// node i's box min3, max3 at bounds[6i] (three 8-byte loads) and its links
// at links[2i] (one 8-byte load: the skip link, and the leaf's handle in the
// leaf loader's terms, K1's leaf index or the v1 walk's first leaf row, or
// -1 for an inner node); each leaf's real-row count at
// counts[Tiles::leaf_index(handle)] (serve_leaves). The wrappers check the
// alignment.
struct Threaded {
  const float* __restrict__ bounds;
  const int* __restrict__ links;
  const int* __restrict__ counts;
  int num_nodes;
};

// One lane's resumable walk of a Threaded tree (the plain version:
// ops/traverse.py::walk_ranges), stepped to its next entered leaf (whose
// handle it then holds) or to its end: it enters a node when the slab test
// passes with t_far capped by its best t so far, moves to cur + 1 at an
// entered inner node, else to the skip link.
struct LaneWalk {
  Ray r;
  Best b;
  bool done;
  int cur = 0;
  int leaf = 0;

  __device__ __forceinline__ bool step(const Threaded& t) {
    while (!done) {
      if (cur >= t.num_nodes) {
        done = true;
        break;
      }
      const float2* bp = reinterpret_cast<const float2*>(t.bounds) + 3 * cur;
      const float2 lo = __ldg(bp), mid = __ldg(bp + 1), hi = __ldg(bp + 2);
      const float box[6] = {lo.x, lo.y, mid.x, mid.y, hi.x, hi.y};
      const int2 l = __ldg(reinterpret_cast<const int2*>(t.links) + cur);
      const bool hit_box = rptr_stream::slab(box, r, b.t);
      cur = (hit_box && l.y < 0) ? cur + 1 : l.x;
      if (hit_box && l.y >= 0) {
        leaf = l.y;
        return true;
      }
    }
    return false;
  }
};

// One lane's closest hit (b.row = -1: none) or any-hit flag (b.blocked)
// over a Threaded tree: the lanes step their walks and the warp serves
// their pending leaves (serve_leaves, counted) until no lane of the warp
// holds one. ``live``: the lane has a ray (an empty segment, tmax <= tmin,
// walks nothing, as in walk_ranges). Every lane of the warp must call it.
template <bool kAnyHit, class Tiles>
__device__ __forceinline__ Best walk_threaded(const Threaded& t,
                                              const Tiles& tiles,
                                              int scan_from, const Ray& r,
                                              bool live) {
  LaneWalk w{r, Best{r.tmax, -1, 0.0f, 0.0f, false},
             !(live && r.tmax > r.tmin)};
  for (;;) {
    const bool pending = w.step(t);
    const unsigned pend = __ballot_sync(kFull, pending);
    if (pend == 0) break;
    serve_leaves<kAnyHit, Tiles, true>(pending, pend, tiles, r, w.leaf,
                                       Tiles::row0(w.leaf), scan_from, w.b,
                                       t.counts);
    if (kAnyHit && w.b.blocked) w.done = true;
  }
  return w.b;
}

}  // namespace rptr_tlas
