"""BVH construction (host-side, vectorized numpy).

Replaces the reference's Vulkan acceleration-structure builds
(``vulkan/vulkanrt_utils.h:55-187``: BLAS build -> compaction -> TLAS) with
an explicit flattened BVH2 we traverse ourselves on TPU:

- Triangles are Morton-sorted and grouped into fixed-size leaves of
  ``LEAF_SIZE`` (padding with duplicated triangles, so device leaf
  intersection is a fixed-width vector op — no variable-length loops).
- The tree over leaves is a *balanced median split over Morton order*:
  depth is exactly ``ceil(log2(L))``, which bounds the lockstep traversal
  loop and the traversal stack on TPU (divergence-free worst case), at a
  small quality cost vs SAH. (SAH/collapse is a planned optimization; the
  "compaction" step of the reference corresponds to the dense array
  repacking we do by construction.)

Node layout (the traversal-friendly "child AABBs in parent" layout):
- ``child``  (N, 2) int32 — >=0: internal node index; <0: leaf id ``-(l+1)``
- ``cmin/cmax`` (N, 2, 3) float32 — AABBs of both children
- ``leaf_tris`` (L, LEAF_SIZE) int32 — triangle indices, padded by repeat

A degenerate scene with a single leaf gets a root with both children
pointing at that leaf (the second masked by an empty AABB).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

LEAF_SIZE = 4

_EMPTY_MIN = np.float32(np.inf)
_EMPTY_MAX = np.float32(-np.inf)


@dataclass
class BVH:
    child: np.ndarray  # (N,2) i32
    cmin: np.ndarray  # (N,2,3) f32
    cmax: np.ndarray  # (N,2,3) f32
    leaf_tris: np.ndarray  # (L,LEAF_SIZE) i32
    depth: int  # max tree depth (stack bound)
    world_min: np.ndarray  # (3,)
    world_max: np.ndarray  # (3,)

    @property
    def num_nodes(self) -> int:
        return len(self.child)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_tris)


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 3x10-bit fixed point coords into 30-bit Morton codes."""

    def expand(v):
        v = v.astype(np.uint64) & np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return (expand(x) << np.uint64(2)) | (expand(y) << np.uint64(1)) | expand(z)


def build_bvh(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, leaf_size: int = LEAF_SIZE
) -> BVH:
    """Build from triangle soup (v0, edge1, edge2), each (T,3) float32.

    ``leaf_size`` trades tree depth (traversal steps, the latency-bound
    currency on TPU) against dense per-leaf intersection work (the cheap
    currency); the Pallas kernel uses 128, the XLA fallback 4.
    """
    v0 = np.asarray(v0, np.float32)
    v1 = v0 + np.asarray(e1, np.float32)
    v2 = v0 + np.asarray(e2, np.float32)
    t = len(v0)
    if t == 0:
        raise ValueError("empty scene")

    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)

    wmin = tmin.min(axis=0)
    wmax = tmax.max(axis=0)
    extent = np.maximum(wmax - wmin, 1e-12)
    q = np.clip(((centroid - wmin) / extent) * 1024.0, 0, 1023).astype(np.uint32)
    codes = morton3d(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int32)

    # group into leaves of leaf_size, pad by repeating the last triangle
    num_leaves = (t + leaf_size - 1) // leaf_size
    padded = np.empty(num_leaves * leaf_size, np.int32)
    padded[:t] = order
    padded[t:] = order[-1]
    leaf_tris = padded.reshape(num_leaves, leaf_size)

    # leaf AABBs
    lt = leaf_tris.reshape(-1)
    lmin = tmin[lt].reshape(num_leaves, leaf_size, 3).min(axis=1)
    lmax = tmax[lt].reshape(num_leaves, leaf_size, 3).max(axis=1)

    if num_leaves == 1:
        child = np.array([[-1, -1]], np.int32)
        cmin = np.stack([lmin[0], np.full(3, _EMPTY_MIN)], 0)[None]
        cmax = np.stack([lmax[0], np.full(3, _EMPTY_MAX)], 0)[None]
        return BVH(
            child=child,
            cmin=cmin.astype(np.float32),
            cmax=cmax.astype(np.float32),
            leaf_tris=leaf_tris,
            depth=1,
            world_min=wmin,
            world_max=wmax,
        )

    # ---- balanced median-split tree over leaf order, built level by level.
    # Each pending range is one internal node; ranges of size 1 are leaves.
    n_internal = num_leaves - 1
    child = np.empty((n_internal, 2), np.int32)
    node_range = np.empty((n_internal, 2), np.int64)  # (start, size) per node

    node_range[0] = (0, num_leaves)
    next_node = 1
    level_nodes = np.array([0], np.int64)
    levels = [level_nodes]
    depth = 1
    while len(level_nodes) > 0:
        starts = node_range[level_nodes, 0]
        sizes = node_range[level_nodes, 1]
        left_sz = sizes // 2
        right_sz = sizes - left_sz

        new_nodes = []
        for side, (s0, sz) in enumerate(
            ((starts, left_sz), (starts + left_sz, right_sz))
        ):
            is_leaf = sz == 1
            # leaves: encode -(leaf_id+1)
            child[level_nodes[is_leaf], side] = -(s0[is_leaf] + 1)
            internal = ~is_leaf
            n_new = int(internal.sum())
            if n_new:
                ids = np.arange(next_node, next_node + n_new, dtype=np.int64)
                next_node += n_new
                child[level_nodes[internal], side] = ids.astype(np.int32)
                node_range[ids, 0] = s0[internal]
                node_range[ids, 1] = sz[internal]
                new_nodes.append(ids)
        level_nodes = (
            np.concatenate(new_nodes) if new_nodes else np.array([], np.int64)
        )
        if len(level_nodes):
            levels.append(level_nodes)
            depth += 1

    assert next_node == n_internal

    # ---- bottom-up AABBs, vectorized per level (deepest first)
    nmin = np.empty((n_internal, 3), np.float32)
    nmax = np.empty((n_internal, 3), np.float32)
    cmin = np.empty((n_internal, 2, 3), np.float32)
    cmax = np.empty((n_internal, 2, 3), np.float32)
    for lvl in reversed(levels):
        c = child[lvl]  # (k,2)
        for side in range(2):
            ci = c[:, side]
            leaf_mask = ci < 0
            li = -(ci + 1)
            src_min = np.where(
                leaf_mask[:, None], lmin[np.where(leaf_mask, li, 0)], nmin[np.where(leaf_mask, 0, ci)]
            )
            src_max = np.where(
                leaf_mask[:, None], lmax[np.where(leaf_mask, li, 0)], nmax[np.where(leaf_mask, 0, ci)]
            )
            cmin[lvl, side] = src_min
            cmax[lvl, side] = src_max
        nmin[lvl] = cmin[lvl].min(axis=1)
        nmax[lvl] = cmax[lvl].max(axis=1)

    return BVH(
        child=child,
        cmin=cmin,
        cmax=cmax,
        leaf_tris=leaf_tris,
        depth=depth,
        world_min=wmin,
        world_max=wmax,
    )


@dataclass
class ThreadedBVH:
    """Stackless DFS-threaded layout for TPU traversal (ops/traverse.py).

    TPUs have no efficient per-lane stacks (scatter-heavy under vmap), so
    traversal follows preorder with *skip links*: on AABB hit the next node
    is ``cur + 1`` (preorder child), on miss/leaf it is ``skip[cur]`` (next
    subtree in preorder). One contiguous row gather per step, zero scatters.

    - ``nodes``   (M, 8) f32: [aabb_min, aabb_max, bitcast(skip),
      bitcast(leaf_row)]; leaf_row = first padded triangle row for leaf
      nodes, -1 for internal nodes. M = 2L-1.
    - ``tri_rows`` (4L, 12) f32: [v0, e1, e2, pad] — leaves own 4
      consecutive rows (padding duplicates the leaf's last triangle).
    - ``row_tri`` (4L,) i32: original triangle index per row.
    """

    nodes: np.ndarray
    tri_rows: np.ndarray
    row_tri: np.ndarray
    depth: int
    world_min: np.ndarray
    world_max: np.ndarray
    leaf_size: int = LEAF_SIZE

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)


def thread_bvh(bvh: BVH, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> ThreadedBVH:
    """Flatten a BVH into the threaded preorder layout (fully vectorized:
    preorder indices computed level by level from subtree sizes)."""
    L = bvh.num_leaves
    leaf_size = bvh.leaf_tris.shape[1]
    if L == 1:
        # single leaf: one node
        nodes = np.zeros((1, 8), np.float32)
        nodes[0, 0:3] = bvh.world_min
        nodes[0, 3:6] = bvh.world_max
        nodes[0, 6] = np.float32(np.frombuffer(np.int32(1).tobytes(), np.float32)[0])
        nodes[0, 7] = np.frombuffer(np.int32(0).tobytes(), np.float32)[0]
        tri_rows, row_tri = _pack_tri_rows(bvh.leaf_tris, v0, e1, e2)
        return ThreadedBVH(
            nodes=nodes,
            tri_rows=tri_rows,
            row_tri=row_tri,
            depth=1,
            world_min=bvh.world_min,
            world_max=bvh.world_max,
            leaf_size=leaf_size,
        )

    n_int = bvh.num_nodes  # internal nodes (L-1)
    M = 2 * L - 1

    # subtree leaf counts per internal node, from ranges implicit in child
    # structure: recompute via child traversal level by level
    leaves_in = np.zeros(n_int, np.int64)
    # process levels bottom-up: a node's leaf count = sum of children's
    levels = []
    cur = np.array([0], np.int64)
    while len(cur):
        levels.append(cur)
        c = bvh.child[cur].reshape(-1)
        cur = c[c >= 0].astype(np.int64)
    for lvl in reversed(levels):
        c = bvh.child[lvl]
        cnt = np.zeros(len(lvl), np.int64)
        for side in range(2):
            ci = c[:, side]
            is_leaf = ci < 0
            cnt += np.where(is_leaf, 1, leaves_in[np.where(is_leaf, 0, ci)])
        leaves_in[lvl] = cnt

    def subtree_nodes_of_child(ci):
        """ci: child entry (neg = leaf)."""
        return np.where(ci < 0, 1, 2 * leaves_in[np.clip(ci, 0, None)] - 1)

    # preorder + skip per (internal/leaf) node, level by level from root
    pre_int = np.zeros(n_int, np.int64)  # preorder index of internal nodes
    skip_int = np.zeros(n_int, np.int64)
    pre_leaf = np.zeros(L, np.int64)
    skip_leaf = np.zeros(L, np.int64)
    pre_int[0] = 0
    skip_int[0] = M
    for lvl in levels:
        c = bvh.child[lvl]
        p = pre_int[lvl]
        s = skip_int[lvl]
        c0, c1 = c[:, 0], c[:, 1]
        size0 = subtree_nodes_of_child(c0)
        p0 = p + 1
        p1 = p + 1 + size0
        s0 = p1
        s1 = s
        for ci, pi, si in ((c0, p0, s0), (c1, p1, s1)):
            leaf_mask = ci < 0
            li = -(ci + 1)
            pre_leaf[li[leaf_mask]] = pi[leaf_mask]
            skip_leaf[li[leaf_mask]] = si[leaf_mask]
            ii = ci[~leaf_mask]
            pre_int[ii] = pi[~leaf_mask]
            skip_int[ii] = si[~leaf_mask]

    # node AABBs: internal from cmin/cmax union, leaves from child slots
    nodes = np.zeros((M, 8), np.float32)
    int_min = bvh.cmin.min(axis=1)
    int_max = bvh.cmax.max(axis=1)
    nodes[pre_int, 0:3] = int_min
    nodes[pre_int, 3:6] = int_max
    # leaf AABBs: find them from parents' child slots
    leaf_min = np.zeros((L, 3), np.float32)
    leaf_max = np.zeros((L, 3), np.float32)
    for side in range(2):
        ci = bvh.child[:, side]
        m = ci < 0
        li = -(ci[m] + 1)
        leaf_min[li] = bvh.cmin[m, side]
        leaf_max[li] = bvh.cmax[m, side]
    nodes[pre_leaf, 0:3] = leaf_min
    nodes[pre_leaf, 3:6] = leaf_max

    skip_all = np.zeros(M, np.int32)
    skip_all[pre_int] = skip_int.astype(np.int32)
    skip_all[pre_leaf] = skip_leaf.astype(np.int32)
    leaf_row = np.full(M, -1, np.int32)
    # reorder leaves by preorder position so their tri rows are DFS-ordered
    leaf_order = np.argsort(pre_leaf, kind="stable")  # leaf ids in DFS order
    dfs_pos = np.empty(L, np.int64)
    dfs_pos[leaf_order] = np.arange(L)
    leaf_row[pre_leaf] = (dfs_pos * leaf_size).astype(np.int32)

    nodes[:, 6] = skip_all.view(np.float32)
    nodes[:, 7] = leaf_row.view(np.float32)

    tri_rows, row_tri = _pack_tri_rows(bvh.leaf_tris[leaf_order], v0, e1, e2)
    return ThreadedBVH(
        nodes=nodes,
        tri_rows=tri_rows,
        row_tri=row_tri,
        depth=bvh.depth,
        world_min=bvh.world_min,
        world_max=bvh.world_max,
        leaf_size=leaf_size,
    )


def _pack_tri_rows(leaf_tris: np.ndarray, v0, e1, e2):
    """(L,leaf_size) tri ids -> ((L*leaf_size,12) f32 rows, i32 tri ids)."""
    flat = leaf_tris.reshape(-1).astype(np.int64)
    rows = np.zeros((len(flat), 12), np.float32)
    rows[:, 0:3] = v0[flat]
    rows[:, 3:6] = e1[flat]
    rows[:, 6:9] = e2[flat]
    return rows, flat.astype(np.int32)


def build_bvh_sah(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
    leaf_size: int = LEAF_SIZE, num_bins: int = 12,
) -> BVH:
    """Top-down binned-SAH build (the quality builder the reference gets
    from the Vulkan implementation's PREFER_FAST_TRACE BLAS builds,
    vulkanrt_utils.h:55-187): recursive greedy surface-area-heuristic
    splits over ``num_bins`` centroid bins per axis, median fallback on
    degenerate distributions. Produces the same BVH structure as
    build_bvh (leaves padded to ``leaf_size``), so thread_bvh and every
    traversal path consume it unchanged. Fewer node visits per ray than
    the Morton median-split tree on irregular geometry."""
    v0 = np.asarray(v0, np.float32)
    v1 = v0 + np.asarray(e1, np.float32)
    v2 = v0 + np.asarray(e2, np.float32)
    t = len(v0)
    if t == 0:
        raise ValueError("empty scene")
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)
    wmin, wmax = tmin.min(axis=0), tmax.max(axis=0)

    leaf_list = []  # list of (leaf_size,) i32
    lmin_list, lmax_list = [], []
    child_rows, cmin_rows, cmax_rows = [], [], []

    def make_leaf(idx):
        lid = len(leaf_list)
        pad = np.empty(leaf_size, np.int32)
        pad[: len(idx)] = idx
        pad[len(idx):] = idx[-1]
        leaf_list.append(pad)
        lmin_list.append(tmin[idx].min(axis=0))
        lmax_list.append(tmax[idx].max(axis=0))
        return -(lid + 1), lmin_list[-1], lmax_list[-1]

    import sys

    limit = max(sys.getrecursionlimit(), 64 + 2 * int(np.ceil(np.log2(max(t, 2)))) * 64)
    sys.setrecursionlimit(limit)

    # depth guard: SAH can chain skewed splits on adversarial input;
    # beyond this bound force balanced median splits (log depth from there)
    max_sah_depth = 2 * int(np.ceil(np.log2(max(t / leaf_size, 2)))) + 16

    def rec(idx, depth):
        if len(idx) <= leaf_size:
            return make_leaf(idx) + (depth,)
        c = centroid[idx]
        cmin_, cmax_ = c.min(axis=0), c.max(axis=0)
        ext = cmax_ - cmin_
        best = None  # (cost, axis, bin_split)
        live_axes = (
            [a for a in range(3) if ext[a] > 1e-12]
            if depth <= max_sah_depth else []
        )
        if live_axes:
            # one fused binning pass over all live axes: per-axis bins
            # offset into a single (A*num_bins) segment table so the
            # expensive ufunc.at/bincount run ONCE per node, not per axis
            scale = num_bins / ext[live_axes]
            b3 = np.minimum(
                ((c[:, live_axes] - cmin_[live_axes]) * scale).astype(
                    np.int64
                ),
                num_bins - 1,
            )  # (n, A)
            off = b3 + np.arange(len(live_axes)) * num_bins
            nb_all = len(live_axes) * num_bins
            counts = np.bincount(off.ravel(), minlength=nb_all).reshape(
                len(live_axes), num_bins
            )
            bmins = np.full((nb_all, 3), np.inf, np.float32)
            bmaxs = np.full((nb_all, 3), -np.inf, np.float32)
            rep_min = np.repeat(tmin[idx], len(live_axes), axis=0)
            np.minimum.at(bmins, off.ravel(), rep_min)
            np.maximum.at(
                bmaxs, off.ravel(), np.repeat(tmax[idx], len(live_axes), axis=0)
            )
            bmins = bmins.reshape(len(live_axes), num_bins, 3)
            bmaxs = bmaxs.reshape(len(live_axes), num_bins, 3)
            # prefix/suffix sweeps, all axes at once
            lcnt = np.cumsum(counts, axis=1)[:, :-1]
            rcnt = len(idx) - lcnt
            lmn = np.minimum.accumulate(bmins, axis=1)[:, :-1]
            lmx = np.maximum.accumulate(bmaxs, axis=1)[:, :-1]
            rmn = np.minimum.accumulate(bmins[:, ::-1], axis=1)[:, ::-1][:, 1:]
            rmx = np.maximum.accumulate(bmaxs[:, ::-1], axis=1)[:, ::-1][:, 1:]

            def area_v(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return (
                    d[..., 0] * d[..., 1]
                    + d[..., 1] * d[..., 2]
                    + d[..., 2] * d[..., 0]
                )

            cost = area_v(lmn, lmx) * lcnt + area_v(rmn, rmx) * rcnt
            ok = (lcnt > 0) & (rcnt > 0)
            cost = np.where(ok, cost, np.inf)
            flat = int(np.argmin(cost))
            ai, i = divmod(flat, num_bins - 1)
            if np.isfinite(cost[ai, i]):
                best = (cost[ai, i], live_axes[ai], i, b3[:, ai])
        if best is None:
            # all centroids coincide: median split in index order
            half = len(idx) // 2
            left, right = idx[:half], idx[half:]
        else:
            _, axis, i, b = best
            sel = b <= i
            left, right = idx[sel], idx[~sel]
        nid = len(child_rows)
        child_rows.append([0, 0])
        cmin_rows.append(np.zeros((2, 3), np.float32))
        cmax_rows.append(np.zeros((2, 3), np.float32))
        l_id, l_mn, l_mx, l_d = rec(left, depth + 1)
        r_id, r_mn, r_mx, r_d = rec(right, depth + 1)
        child_rows[nid] = [l_id, r_id]
        cmin_rows[nid][0], cmin_rows[nid][1] = l_mn, r_mn
        cmax_rows[nid][0], cmax_rows[nid][1] = l_mx, r_mx
        return (
            nid,
            np.minimum(l_mn, r_mn),
            np.maximum(l_mx, r_mx),
            max(l_d, r_d),
        )

    root, _mn, _mx, depth = rec(np.arange(t, dtype=np.int32), 1)
    if root < 0:
        # single leaf: mirror build_bvh's degenerate shape
        child = np.array([[-1, -1]], np.int32)
        cmin = np.stack(
            [lmin_list[0], np.full(3, _EMPTY_MIN, np.float32)], 0
        )[None]
        cmax = np.stack(
            [lmax_list[0], np.full(3, _EMPTY_MAX, np.float32)], 0
        )[None]
        return BVH(
            child=child,
            cmin=cmin.astype(np.float32),
            cmax=cmax.astype(np.float32),
            leaf_tris=np.stack(leaf_list),
            depth=1,
            world_min=wmin,
            world_max=wmax,
        )
    assert root == 0  # preorder: the first emitted internal node is the root
    return BVH(
        child=np.asarray(child_rows, np.int32),
        cmin=np.stack(cmin_rows).astype(np.float32),
        cmax=np.stack(cmax_rows).astype(np.float32),
        leaf_tris=np.stack(leaf_list),
        depth=depth,
        world_min=wmin,
        world_max=wmax,
    )


def build_threaded_bvh(v0, e1, e2, leaf_size: int = LEAF_SIZE,
                       builder: str = "morton") -> ThreadedBVH:
    """Build + thread in one call (the BLAS build path). ``builder``:
    "morton" (median split, fastest build) or "sah" (binned SAH, fewer
    node visits per ray)."""
    build = build_bvh_sah if builder == "sah" else build_bvh
    return thread_bvh(build(v0, e1, e2, leaf_size), v0, e1, e2)


def refit_bvh(bvh: BVH, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> BVH:
    """Recompute AABBs for unchanged topology (the reference's BVH refit /
    UpdateBLAS path, vulkanrt_utils.h:92-101). Vectorized host numpy by
    design: the refit output must be re-threaded and re-uploaded with
    the moved vertex arrays anyway (both host-side), so a device kernel
    would only move the cheapest step; the streamed path's
    traverse_stream.refit_streamed applies the same level-sweep trick
    directly in the packed kernel layout."""
    v0 = np.asarray(v0, np.float32)
    v1 = v0 + e1
    v2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    leaf_size = bvh.leaf_tris.shape[1]
    lt = bvh.leaf_tris.reshape(-1)
    nl = bvh.num_leaves
    lmin = tmin[lt].reshape(nl, leaf_size, 3).min(axis=1)
    lmax = tmax[lt].reshape(nl, leaf_size, 3).max(axis=1)

    # recompute levels by walking from root
    n = bvh.num_nodes
    nmin = np.empty((n, 3), np.float32)
    nmax = np.empty((n, 3), np.float32)
    cmin = bvh.cmin.copy()
    cmax = bvh.cmax.copy()

    levels = []
    cur = np.array([0], np.int64)
    while len(cur):
        levels.append(cur)
        c = bvh.child[cur].reshape(-1)
        cur = c[c >= 0].astype(np.int64)
    for lvl in reversed(levels):
        c = bvh.child[lvl]
        for side in range(2):
            ci = c[:, side]
            leaf_mask = ci < 0
            li = -(ci + 1)
            empty = np.isinf(bvh.cmin[lvl, side, 0])  # preserve empty slots
            src_min = np.where(
                leaf_mask[:, None],
                lmin[np.where(leaf_mask, li, 0)],
                nmin[np.where(leaf_mask, 0, ci)],
            )
            src_max = np.where(
                leaf_mask[:, None],
                lmax[np.where(leaf_mask, li, 0)],
                nmax[np.where(leaf_mask, 0, ci)],
            )
            cmin[lvl, side] = np.where(empty[:, None], bvh.cmin[lvl, side], src_min)
            cmax[lvl, side] = np.where(empty[:, None], bvh.cmax[lvl, side], src_max)
        nmin[lvl] = cmin[lvl].min(axis=1)
        nmax[lvl] = cmax[lvl].max(axis=1)

    return BVH(
        child=bvh.child,
        cmin=cmin,
        cmax=cmax,
        leaf_tris=bvh.leaf_tris,
        depth=bvh.depth,
        world_min=nmin[0],
        world_max=nmax[0],
    )
