"""Streamed two-level traversal: the K4 kernel's pack, wrappers and plain
version.

Counterpart of the reference's ``ops/traverse_stream.py``. Scenes above the
resident cap are chunked into SUBTREES of at most ``CHUNK_TRIS`` triangles
by recursive spatial median splits (``_split_chunks``); each subtree gets a
binned-SAH threaded BVH of 128-triangle leaves, and a small TOP tree
(``_build_top_tree``) covers the subtree boxes. The pack
(``pack_streamed``, host numpy) lays this out as the kernels read it:

- ``top_nodes`` (Mt, 8) f32: [min3, max3, skip, subtree id or -1], the
  links as float VALUES (exact below 2^24), not bit patterns;
- ``sub_nodes`` (S*R, 128) f32: subtree s owns rows [s*R, (s+1)*R), 16
  nodes of 8 floats per row, node i at flat offset 8*i: [min3, max3,
  skip or ``SUB_EXIT``, LOCAL leaf id or -1], float values again;
- ``tri_tiles`` (S*L*16, 128) f32: subtree s, local leaf l owns the
  field-major tile rows [(s*L + l)*16, +16): row f is field f (v0, e1,
  e2 xyz) of the leaf's 128 triangles; or, in a 16-bit quantized pack
  (``pack_streamed(quantize=True)``), int16 codes offset by -32768 (rows
  0-8: q0, q1, q2 xyz) of a per-subtree grid whose min and scale ride the
  spare last slot of the subtree's node block (``dequant_tile``);
- ``row_tri`` (S*L*128,) i32: global row -> source triangle. A global
  row is ``(s*L + l)*128 + k``.

K4 (``closest_hit_streamed`` / ``occluded_streamed``; reference
``_kernel_streamed``) walks, per ray, the top tree in preorder with the
slab test capped at the ray's best hit, and every subtree it enters with
the same stackless walk, running Möller-Trumbore over each entered leaf's
128 triangles. Hits improve strictly, so on an exact t tie the FIRST
VISITED triangle wins: subtrees in top-tree preorder, leaves in each
subtree's preorder, the lower row inside a leaf. Subtree ids (and so
global rows) follow ``_split_chunks`` order, not top-tree preorder, so the
winner of a tie across subtrees is not the lower row. ``plain`` implements
this rule with the port's plain threaded walk (``ops/traverse.py``), and
the CUDA kernel ``csrc/traverse_streamed.cu`` must equal it bitwise.

K4's merged mode (``closest_and_occluded_streamed``; reference :967) runs
a closest queue in its first blocks and a shadow queue after it, in one
launch. Its ordered mode (``closest_hit_streamed(ordered=True)``; reference
:650-715, per ray here) visits each ray's subtrees nearest first
(``plain_ordered``).

On a CPU tensor the wrappers run ``plain``; on a CUDA tensor they launch
the kernel (built by ``kernels/build.py`` at first use) or raise.
``launches_k4`` counts the kernel's launches (``merged_launches_k4`` and
``launches_k4_ordered`` those of its modes).
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, NamedTuple

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops.bvh import build_threaded_bvh
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import (
    T_MAX,
    ray_aabb,
    safe_inv_dir,
)
from realtimepathtracingresearchframework_tpu_torch.ops.tlas import ordered_sweep
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    Hit,
    ResidentBVH,
    real_row_counts,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    _check,
    _check_aligned,
    _coherence_key2,
    coherence_key,
    inverse_permutation,
    merged,
    pack_rays,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

KERNEL = "traverse_streamed"  # csrc/traverse_streamed.cu
LEAF = 128
SUB_LEAVES = 64  # default leaf slots per subtree
CHUNK_TRIS = SUB_LEAVES * LEAF  # 8192 -> <= 127 threaded nodes per subtree
SUB_EXIT = 255  # local skip value meaning "leave the subtree"
DEFAULT_BLOCK = 512

BLOCK = 128  # rays per CUDA block (kThreads of csrc/stream_walk.cuh)

launches_k4 = 0  # K4 launches in this process (reset with reset_launches)
merged_launches_k4 = 0  # of which merged two-queue launches
launches_k4_ordered = 0  # of which ordered (front-to-back) launches


def reset_launches() -> None:
    global launches_k4, merged_launches_k4, launches_k4_ordered
    launches_k4 = merged_launches_k4 = launches_k4_ordered = 0


def node_rows_for(sub_leaves: int) -> int:
    """Node-block rows of 16 slots for a subtree of ``sub_leaves`` leaves:
    room for the worst threaded tree (2*leaves - 1 nodes) plus one spare
    slot (8 rows at 64 leaves)."""
    return max(1, -(-(2 * sub_leaves) // 16))


class StreamedBVHBuffers(NamedTuple):
    """The streamed pack on one device (see the module docstring)."""

    top_nodes: torch.Tensor  # (Mt, 8) f32: min3, max3, skip, subtree | -1
    sub_nodes: torch.Tensor  # (S*R, 128) f32: packed subtree nodes
    tri_tiles: torch.Tensor  # (S*L*16, 128) f32 field-major leaf tiles,
    # or int16 codes of a quantized pack
    row_tri: torch.Tensor  # (S*L*128,) i32: global row -> source triangle
    sub_leaves: int = SUB_LEAVES  # leaf slots per subtree

    @property
    def num_top_nodes(self) -> int:
        return self.top_nodes.shape[0]

    @property
    def quantized(self) -> bool:
        return self.tri_tiles.dtype == torch.int16

    @property
    def sub_node_rows(self) -> int:
        return node_rows_for(self.sub_leaves)

    @property
    def num_subtrees(self) -> int:
        return self.sub_nodes.shape[0] // self.sub_node_rows


class StreamedTopology(NamedTuple):
    """Static structure of a streamed pack, kept for a later refit
    (``refit_streamed``): chunk assignment, each subtree's
    threaded-tree shape and slot gathers. Host numpy."""

    gather: np.ndarray  # (S*L*LEAF,) i64 source tri per slot, -1 pad
    node_end: np.ndarray  # (S, R*16) i32 preorder subtree-range end
    node_leaf: np.ndarray  # (S, R*16) i32 LOCAL leaf id of leaf nodes, -1
    node_count: np.ndarray  # (S,) i32
    sub_nodes_base: np.ndarray  # (S, R, 128) f32
    sub_leaves: int = SUB_LEAVES


# ---------------------------------------------------------------------------
# Host pack (traverse_stream.py:106-358), numpy
# ---------------------------------------------------------------------------


def _build_top_tree(cmin: np.ndarray, cmax: np.ndarray) -> np.ndarray:
    """Threaded preorder top tree over subtree AABBs: largest-axis median
    splits of the box centroids; a leaf's payload is its subtree id."""
    n = len(cmin)
    centroid = 0.5 * (cmin + cmax)
    nodes: List[np.ndarray] = []

    def emit(idxs: np.ndarray) -> int:
        """Appends the nodes of ``idxs`` in preorder; returns their count."""
        my = len(nodes)
        row = np.zeros(8, np.float32)
        row[0:3] = cmin[idxs].min(axis=0)
        row[3:6] = cmax[idxs].max(axis=0)
        nodes.append(row)
        if len(idxs) == 1:
            row[7] = np.float32(int(idxs[0]))
            count = 1
        else:
            ext = centroid[idxs].max(axis=0) - centroid[idxs].min(axis=0)
            axis = int(np.argmax(ext))
            order = idxs[np.argsort(centroid[idxs, axis], kind="stable")]
            half = len(order) // 2
            row[7] = np.float32(-1.0)
            count = 1 + emit(order[:half]) + emit(order[half:])
        row[6] = np.float32(my + count)  # skip: the next preorder subtree
        return count

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * n + 100))
    try:
        emit(np.arange(n))
    finally:
        sys.setrecursionlimit(old)
    return np.stack(nodes)


def _split_chunks(centroid: np.ndarray,
                  chunk_tris: int = CHUNK_TRIS) -> List[np.ndarray]:
    """Recursive largest-axis median splits into chunks of at most
    ``chunk_tris`` triangles, the split points snapped to multiples of
    ``chunk_tris`` so chunks stay full."""
    out: List[np.ndarray] = []
    stack = [np.arange(len(centroid), dtype=np.int64)]
    while stack:
        idx = stack.pop()
        if len(idx) <= chunk_tris:
            out.append(idx)
            continue
        ext = centroid[idx].max(axis=0) - centroid[idx].min(axis=0)
        axis = int(np.argmax(ext))
        order = idx[np.argsort(centroid[idx, axis], kind="stable")]
        half = (len(order) // 2 + chunk_tris - 1) // chunk_tris * chunk_tris
        half = min(max(half, chunk_tris), len(order) - 1)
        stack.append(order[half:])
        stack.append(order[:half])
    return out


def quantize_chunk(v0c, v1c, v2c):
    """Per-subtree 16-bit grid quantization of a chunk's vertices
    (traverse_stream.py:171-214): the grid spans the chunk's box in 65,535
    steps per axis (1 on a flat axis). Returns (q0, q1, q2 u16 codes,
    grid_min f32[3], grid_scale f32[3], v0r, e1r, e2r), where the
    reconstruction is what the kernels' decode computes:
    ``v0r = gmin + q0 * scale``, ``e1r = (q1 - q0) * scale``, f32 ops in
    that order."""
    gmin = np.minimum(np.minimum(v0c, v1c), v2c).min(axis=0)
    gmax = np.maximum(np.maximum(v0c, v1c), v2c).max(axis=0)
    ext = (gmax - gmin).astype(np.float32)
    scale = np.where(ext > 0, ext / 65535.0, 1.0).astype(np.float32)
    gmin = gmin.astype(np.float32)

    def q(v):
        return np.clip(np.rint((v - gmin) / scale), 0, 65535).astype(np.uint16)

    q0, q1, q2 = q(v0c), q(v1c), q(v2c)
    f0, f1, f2 = (x.astype(np.float32) for x in (q0, q1, q2))
    v0r = gmin + f0 * scale
    e1r = (f1 - f0) * scale
    e2r = (f2 - f0) * scale
    return q0, q1, q2, gmin, scale, v0r, e1r, e2r


def pick_chunk_tris(num_tris: int) -> int:
    """Subtree size for a scene: about 64 subtrees, in whole leaves, never
    below 1024 triangles and never above ``CHUNK_TRIS``."""
    per = -(-num_tris // 64)
    per = -(-per // LEAF) * LEAF
    return int(min(max(per, 1024), CHUNK_TRIS))


def pack_streamed(v0, e1, e2, quantize: bool = False,
                  with_topology: bool = False, chunk_tris: int = None,
                  device="cpu"):
    """Chunked two-level build and pack (host numpy), uploaded to
    ``device``. Returns the buffers, and with ``with_topology`` also the
    ``StreamedTopology``. ``chunk_tris`` (a multiple of ``LEAF``) defaults
    to ``pick_chunk_tris``.

    With ``quantize`` (traverse_stream.py:228-320) the leaf tiles hold
    per-subtree 16-bit vertex codes (int16, offset by -32768; rows 0-8 are
    q0, q1, q2 xyz) instead of f32 v0/e1/e2, the six dequant constants
    (grid min, grid scale) ride the spare last node slot of each subtree's
    block, and the subtree BVHs are built over the reconstructed triangles
    (``quantize_chunk``). The quantized pack keeps no refit topology."""
    if quantize and with_topology:
        raise ValueError("the refit topology implies f32 tiles")
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    v1, v2 = v0 + e1, v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)

    if chunk_tris is None:
        chunk_tris = pick_chunk_tris(len(v0))
    assert chunk_tris % LEAF == 0 and chunk_tris > 0
    sub_leaves = chunk_tris // LEAF
    node_rows = node_rows_for(sub_leaves)
    if node_rows * 16 > SUB_EXIT:
        raise ValueError(f"{chunk_tris} tris per subtree: node slots reach "
                         f"the SUB_EXIT sentinel {SUB_EXIT}")

    chunks = _split_chunks(centroid, chunk_tris)
    S = len(chunks)
    sub_nodes = np.zeros((S, node_rows, 128), np.float32)
    tile_list: List[np.ndarray] = []
    row_tri_list: List[np.ndarray] = []
    cmin = np.zeros((S, 3), np.float32)
    cmax = np.zeros((S, 3), np.float32)
    if with_topology:
        topo_gather = np.full((S, chunk_tris), -1, np.int64)
        topo_end = np.zeros((S, node_rows * 16), np.int32)
        topo_leaf = np.full((S, node_rows * 16), -1, np.int32)
        topo_nn = np.zeros((S,), np.int32)
    for s, idx in enumerate(chunks):
        cv0, ce1, ce2 = v0[idx], e1[idx], e2[idx]
        if quantize:
            q0, q1, q2, gmin, gscale, cv0, ce1, ce2 = quantize_chunk(
                cv0, cv0 + ce1, cv0 + ce2)
        # binned SAH inside each subtree; the balanced median split where
        # SAH overruns the fixed node or leaf budget
        tb = build_threaded_bvh(cv0, ce1, ce2, leaf_size=LEAF, builder="sah")
        # a quantized pack keeps the last slot for the dequant constants
        node_cap = node_rows * 16 - (1 if quantize else 0)
        if tb.num_nodes > node_cap or tb.tri_rows.shape[0] // LEAF > sub_leaves:
            tb = build_threaded_bvh(cv0, ce1, ce2, leaf_size=LEAF)
        nn = tb.num_nodes
        assert nn <= node_cap, f"subtree too big: {nn}"
        nodes = tb.nodes.copy()  # (nn, 8): skip, leaf row as int32 bits
        skip = nodes[:, 6].view(np.int32).copy()
        leaf_row = nodes[:, 7].view(np.int32).copy()
        if with_topology:
            topo_end[s, :nn] = np.minimum(skip, nn)
        # local exits -> sentinel; leaf rows -> LOCAL leaf ids
        skip[skip >= nn] = SUB_EXIT
        is_leaf = leaf_row >= 0
        leaf_row[is_leaf] = leaf_row[is_leaf] // LEAF
        nodes[:, 6] = skip.astype(np.float32)
        nodes[:, 7] = leaf_row.astype(np.float32)
        sub_nodes[s].reshape(-1)[: nn * 8] = nodes.reshape(-1)
        rows = tb.tri_rows  # leaf-major rows
        R = rows.shape[0]
        num_leaves = R // LEAF
        assert num_leaves <= sub_leaves
        if quantize:
            # the walk never lands on the last slot: nn <= cap, and exits
            # jump to SUB_EXIT
            sub_nodes[s, node_rows - 1, 120:123] = gmin
            sub_nodes[s, node_rows - 1, 123:126] = gscale
            codes = np.concatenate([q0, q1, q2], axis=1)[tb.row_tri]  # (R, 9)
            tiles = np.zeros((sub_leaves, 16, 128), np.int16)
            tiles[:num_leaves, 0:9, :] = (
                codes.reshape(num_leaves, LEAF, 9).astype(np.int32) - 32768
            ).astype(np.int16).transpose(0, 2, 1)
        else:
            tiles = np.zeros((sub_leaves, 16, 128), np.float32)
            tiles[:num_leaves, 0:9, :] = (
                rows[:, 0:9].reshape(num_leaves, LEAF, 9).transpose(0, 2, 1))
        tile_list.append(tiles.reshape(sub_leaves * 16, 128))
        rt = np.zeros(chunk_tris, np.int32)
        rt[:R] = idx[tb.row_tri].astype(np.int32)
        row_tri_list.append(rt)
        cmin[s] = tb.world_min
        cmax[s] = tb.world_max
        if with_topology:
            topo_gather[s, :R] = idx[tb.row_tri]
            topo_leaf[s, :nn] = leaf_row
            topo_nn[s] = nn

    top = _build_top_tree(cmin, cmax)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    bb = StreamedBVHBuffers(
        top_nodes=up(top),
        sub_nodes=up(sub_nodes.reshape(S * node_rows, 128)),
        tri_tiles=up(np.concatenate(tile_list, axis=0)),
        row_tri=up(np.concatenate(row_tri_list)),
        sub_leaves=sub_leaves,
    )
    if with_topology:
        return bb, StreamedTopology(
            gather=topo_gather.reshape(-1), node_end=topo_end,
            node_leaf=topo_leaf, node_count=topo_nn, sub_nodes_base=sub_nodes,
            sub_leaves=sub_leaves,
        )
    return bb


def refit_streamed(topo: StreamedTopology, v0, e1, e2,
                   device="cpu") -> StreamedBVHBuffers:
    """Refit a streamed pack to moved vertices with its topology unchanged
    (traverse_stream.py:361-438; the BLAS update path, vulkanrt_utils.h:
    92-101): the leaf tiles re-gathered by the stored slot order, the leaf
    boxes recomputed and folded into the node boxes through the stored
    preorder ranges, and the top tree rebuilt over the new subtree roots.
    Host numpy, uploaded to ``device``.

    Every slot of a leaf, its padding rows included, re-gathers the source
    triangle the pack put there, so a padded leaf still repeats its last
    triangle bit for bit and each leaf's real-row count read from the
    tiles' bits (``traverse.real_row_counts`` of ``leaf_rows``) is the one
    a fresh pack of the same topology and vertices gives; unused slots stay
    zero, as in the pack."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    g = topo.gather
    S = topo.node_count.shape[0]
    sub_leaves = topo.sub_leaves
    node_rows = node_rows_for(sub_leaves)
    slots = node_rows * 16
    valid = g >= 0
    gi = np.where(valid, g, 0)

    sv0, se1, se2 = v0[gi], e1[gi], e2[gi]
    fields = np.concatenate([sv0, se1, se2], axis=1)  # (S*L*LEAF, 9)
    fields[~valid] = 0.0
    tiles = np.zeros((S * sub_leaves, 16, 128), np.float32)
    tiles[:, 0:9, :] = fields.reshape(S * sub_leaves, LEAF, 9).transpose(0, 2, 1)

    # leaf boxes (unused slots contribute nothing)
    w1, w2 = sv0 + se1, sv0 + se2
    tmin = np.minimum(np.minimum(sv0, w1), w2)
    tmax = np.maximum(np.maximum(sv0, w1), w2)
    big = np.float32(np.inf)
    tmin = np.where(valid[:, None], tmin, big)
    tmax = np.where(valid[:, None], tmax, -big)
    lmin = tmin.reshape(S, sub_leaves, LEAF, 3).min(axis=2)  # (S, L, 3)
    lmax = tmax.reshape(S, sub_leaves, LEAF, 3).max(axis=2)

    # node boxes by prefix sums over preorder leaf presence: node i of
    # subtree s covers the leaves met at preorder positions [i, end_i)
    P = np.zeros((S, slots + 1, sub_leaves), np.float32)
    sj, nj = np.nonzero(topo.node_leaf >= 0)
    P[sj, nj + 1, topo.node_leaf[sj, nj]] = 1.0
    C = np.cumsum(P, axis=1)  # (S, slots + 1, L)
    ii = np.arange(slots)
    C_end = np.take_along_axis(
        C, topo.node_end[:, :, None].astype(np.int64), axis=1)
    covered = (C_end - C[:, 0:slots, :]) > 0  # (S, slots, L)
    node_valid = ii[None, :] < topo.node_count[:, None]
    nmin = np.where(covered[..., None], lmin[:, None, :, :], big).min(axis=2)
    nmax = np.where(covered[..., None], lmax[:, None, :, :], -big).max(axis=2)

    sub = topo.sub_nodes_base.copy()  # (S, R, 128), links preserved
    r = ii // 16
    base = (ii % 16) * 8
    for k in range(3):
        sub[:, r, base + k] = np.where(node_valid, nmin[..., k],
                                       sub[:, r, base + k])
        sub[:, r, base + 3 + k] = np.where(node_valid, nmax[..., k],
                                           sub[:, r, base + 3 + k])

    top = _build_top_tree(nmin[:, 0, :].astype(np.float32),
                          nmax[:, 0, :].astype(np.float32))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return StreamedBVHBuffers(
        top_nodes=up(top),
        sub_nodes=up(sub.reshape(S * node_rows, 128)),
        tri_tiles=up(tiles.reshape(S * sub_leaves * 16, 128)),
        row_tri=up(np.where(valid, g, 0).astype(np.int32)),
        sub_leaves=sub_leaves,
    )


def reconstruct_quantized(v0, e1, e2, chunk_tris: int = None):
    """The triangles a quantized pack holds (traverse_stream.py:441): each
    chunk of ``pack_streamed(quantize=True)`` through ``quantize_chunk``'s
    reconstruction, in source order. Host numpy (v0, e1, e2)."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    v1, v2 = v0 + e1, v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)
    out0, out1, out2 = np.zeros_like(v0), np.zeros_like(e1), np.zeros_like(e2)
    if chunk_tris is None:
        chunk_tris = pick_chunk_tris(len(v0))
    for idx in _split_chunks(centroid, chunk_tris):
        *_, v0r, e1r, e2r = quantize_chunk(v0[idx], v1[idx], v2[idx])
        out0[idx], out1[idx], out2[idx] = v0r, e1r, e2r
    return out0, out1, out2


def dequant_tile(tiles: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """The kernels' decode of quantized leaf tiles (traverse_stream.py:466):
    int16 codes (..., 16, 128), offset by -32768, and the subtree's
    constants ``dq`` (6,) = grid min xyz, grid scale xyz -> the f32 v0/e1/e2
    field tiles (rows 9-15 zero). v0 = c + (f + 32768) * s and the edges
    (f_k - f_0) * s from code differences, exact in f32, so the decode is
    bitwise ``quantize_chunk``'s reconstruction. Codes go int16 -> int32 ->
    f32, never through float bit patterns."""
    f = tiles[..., 0:9, :].to(torch.int32).to(torch.float32)
    c = dq[0:3].view(3, 1)
    sc = dq[3:6].view(3, 1)
    out = torch.zeros(tiles.shape, dtype=torch.float32, device=tiles.device)
    out[..., 0:3, :] = c + (f[..., 0:3, :] + 32768.0) * sc
    out[..., 3:6, :] = (f[..., 3:6, :] - f[..., 0:3, :]) * sc
    out[..., 6:9, :] = (f[..., 6:9, :] - f[..., 0:3, :]) * sc
    return out


def dequant_constants(bb: StreamedBVHBuffers) -> torch.Tensor:
    """(S, 6) f32: each subtree's grid min and scale, from the spare last
    node slot of its block (``pack_streamed(quantize=True)``)."""
    slots = bb.sub_node_rows * 16
    return bb.sub_nodes.view(-1, slots, 8)[:, slots - 1, 0:6]


def leaf_rows(bb: StreamedBVHBuffers, s: int = None) -> torch.Tensor:
    """The f32 triangle rows (L*128, 9) of subtree ``s``'s leaf tiles, or
    (S*L*128, 9) of every subtree, row ``(s*L + l)*128 + k`` (the global
    row); quantized tiles are decoded by ``dequant_tile``."""
    L = bb.sub_leaves
    tiles = bb.tri_tiles.view(-1, L, 16, LEAF)
    if s is not None:
        tiles = tiles[s:s + 1]
    if bb.quantized:
        dq = dequant_constants(bb)
        dq = dq if s is None else dq[s:s + 1]
        tiles = torch.stack([dequant_tile(t, d) for t, d in zip(tiles, dq)])
    return tiles[:, :, 0:9, :].transpose(2, 3).reshape(-1, 9)


def subtree_resident(bb: StreamedBVHBuffers, s: int) -> ResidentBVH:
    """Subtree ``s`` decoded to the resident layout of the plain walk:
    node boxes, integer links (skip, local leaf; ``SUB_EXIT`` lies past the
    last slot, so the walk leaves there) and the leaf tiles as (L*128, 9)
    rows, whose row index is the LOCAL row ``l*128 + k`` (quantized tiles
    decoded)."""
    slots = bb.sub_node_rows * 16
    nodes = bb.sub_nodes.view(-1, slots, 8)[s]
    L = bb.sub_leaves
    rows = leaf_rows(bb, s)
    return ResidentBVH(
        bounds=nodes[:, 0:6],
        links=nodes[:, 6:8].to(torch.int32),
        tri_rows=rows,
        row_tri=bb.row_tri[s * L * LEAF:(s + 1) * L * LEAF],
        leaf_size=LEAF,
        real_rows=real_row_counts(rows, LEAF),
    )


def leaf_boxes(bb: StreamedBVHBuffers):
    """The boxes of every leaf node of every subtree: (16, Lpad) f32 in the
    layout of ``traverse_flat.leaf_aabbs_for`` (rows 0-2 min, 3-5 max,
    padding columns empty), and (Lpad,) i64 the subtree of each (-1 in
    padding). The leaves the bound of K4 and K5 counts."""
    slots = bb.sub_node_rows * 16
    nodes = bb.sub_nodes.view(-1, 8)
    # a real node's skip link lies past it; unused slots are all zero
    leaf = (nodes[:, 7] >= 0) & (nodes[:, 6] > 0)
    boxes = nodes[leaf, 0:6]
    k = boxes.shape[0]
    lpad = -(-k // 128) * 128
    out = torch.zeros((16, lpad), dtype=torch.float32, device=nodes.device)
    out[0:3] = 3.0e38
    out[3:6] = -3.0e38
    out[0:6, :k] = boxes.T
    sid = torch.full((lpad,), -1, dtype=torch.int64, device=nodes.device)
    sid[:k] = torch.nonzero(leaf).squeeze(1) // slots
    return out, sid


# ---------------------------------------------------------------------------
# Plain version of K4 and the kernel launch
# ---------------------------------------------------------------------------


def plain(bb: StreamedBVHBuffers, rays: torch.Tensor, any_hit: bool,
          ordered: bool = False):
    """The plain version of K4 on a packed (8, N) operand: what the
    wrappers run on CPU tensors, and what ``launch`` must equal on the card.

    Every ray walks the top tree from node 0 in preorder. Rays are
    processed top node by top node in ascending order: a ray's cursor only
    moves forward, so when node j is processed every ray whose cursor is j
    is there. A ray that enters a subtree-leaf of the top tree walks that
    subtree with the port's plain threaded walk (``traverse.walk_ranges``), its
    segment capped at its best hit so far; a hit replaces the best only
    when strictly nearer. ``ordered`` (closest hits only) visits the
    subtrees nearest first instead (``plain_ordered``). Returns (t, row, u,
    v) with global rows, or the blocked flags."""
    if ordered:
        assert not any_hit, "the ordered walk is a closest-hit strategy"
        return plain_ordered(bb, rays)
    n, dev = rays.shape[1], rays.device
    top = bb.top_nodes.cpu().numpy()
    L = bb.sub_leaves
    ro3 = rays[0:3].T
    inv3, zero3 = safe_inv_dir(rays[3:6].T), rays[3:6].T == 0.0
    tmin, tmax = rays[6], rays[7]
    t_best = tmax.clone()
    best_row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    mt = top.shape[0]
    # an empty segment (tmax <= tmin) can never hit: it walks nothing
    cur = torch.where(tmax > tmin, 0, mt)
    for j in range(mt):
        ids = torch.nonzero(cur == j).squeeze(1)
        if not ids.numel():
            continue
        box = bb.top_nodes[j]
        hit_box, _ = ray_aabb(ro3[ids], inv3[ids], box[0:3], box[3:6],
                              tmin[ids], t_best[ids], zero3[ids])
        skip, sid = int(top[j, 6]), int(top[j, 7])
        if sid < 0:
            cur[ids] = torch.where(hit_box, j + 1, skip)
            continue
        cur[ids] = skip
        vi = ids[hit_box]
        if not vi.numel():
            continue
        sub = subtree_resident(bb, sid)
        o, d = Vec3(*rays[0:3, vi]), Vec3(*rays[3:6, vi])
        if any_hit:
            b = traverse.occluded_threaded(sub, o, d, tmin[vi], t_best[vi])
            blocked[vi[b]] = True
            cur[vi[b]] = mt
            continue
        h = traverse.closest_hit_threaded(sub, o, d, tmin[vi], t_best[vi])
        found = h.tri >= 0
        vf = vi[found]
        t_best[vf] = h.t[found]
        best_row[vf] = h.tri[found] + sid * L * LEAF
        best_u[vf] = h.u[found]
        best_v[vf] = h.v[found]
    if any_hit:
        return blocked
    return torch.where(best_row < 0, T_MAX, t_best), best_row, best_u, best_v


def plain_ordered(bb: StreamedBVHBuffers, rays: torch.Tensor):
    """The plain version of K4's ordered walk (traverse_stream.py:650-715,
    per ray): ``tlas.ordered_sweep`` over the top tree, every visited
    subtree walked with the plain threaded walk of K4 (one batched walk
    per round, each ray in its own subtree). Closest hits only; equal to
    the preorder walk's except on exact-t ties across subtrees. Returns
    (t, row, u, v) with global rows."""
    slots = bb.sub_node_rows * 16
    span = bb.sub_leaves * LEAF
    nodes = bb.sub_nodes.view(-1, 8)
    links = nodes[:, 6:8].to(torch.int32)
    rows = leaf_rows(bb)
    top = bb.top_nodes.cpu().numpy()

    def visit(ids, sid, t_cap):
        sid = sid.to(torch.int64)
        return traverse.walk_ranges(
            nodes[:, 0:6], links, rows, LEAF, Vec3(*rays[0:3, ids]),
            Vec3(*rays[3:6, ids]), rays[6, ids], t_cap, False,
            node0=sid * slots, count=slots, row0=sid * span)

    out = ordered_sweep(bb.top_nodes[:, 0:6], top[:, 7].astype(np.int64),
                        rays, visit)
    return out[:4]


def _lib():
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    lib = build.load(KERNEL)
    # every pointer and the stream as c_void_p (a bare Python int would be
    # passed as a 32-bit C int and cut the pointer)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rptr_traverse_streamed.argtypes = (
        [p, i, p, p, i, i, p, i, i, i, i] + [p] * 5 + [p])
    lib.rptr_traverse_streamed.restype = ctypes.c_int
    lib.rptr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rptr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_buffers(bb: StreamedBVHBuffers, dev) -> None:
    """Device, type, shape, contiguity and alignment of the pack's kernel
    operands: f32 tiles, or int16 codes with the dequant constants in each
    node block. K4 reads nodes and f32 tiles in 16-byte loads, int16 tiles
    in 8-byte loads."""
    mt, s, L = bb.num_top_nodes, bb.num_subtrees, bb.sub_leaves
    _check("top_nodes", bb.top_nodes, torch.float32, (mt, 8), dev)
    _check("sub_nodes", bb.sub_nodes, torch.float32,
           (s * bb.sub_node_rows, 128), dev)
    _check("tri_tiles", bb.tri_tiles,
           torch.int16 if bb.quantized else torch.float32, (s * L * 16, 128),
           dev)
    if bb.sub_node_rows * 16 > SUB_EXIT:
        raise ValueError(f"{L} leaves per subtree: too many node slots")
    _check_aligned("top_nodes", bb.top_nodes, 16)
    _check_aligned("sub_nodes", bb.sub_nodes, 16)
    _check_aligned("tri_tiles", bb.tri_tiles, 8 if bb.quantized else 16)


def _launch(bb: StreamedBVHBuffers, rays: torch.Tensor, n_closest: int,
            ordered: bool = False):
    """One K4 launch over a packed (8, N) operand, one lane per ray, in
    blocks of BLOCK: the closest mode on lanes [0, n_closest), the any-hit
    mode on the rest; ``ordered`` walks the closest lanes front to back (a
    closest-only launch). Returns ((t, row, u, v), blocked) of the two
    parts."""
    global launches_k4, launches_k4_ordered
    dev = rays.device
    n = rays.shape[1]
    check_buffers(bb, dev)
    _check("rays", rays, torch.float32, (8, n), dev)
    if not 0 <= n_closest <= n or (n_closest < n and n_closest % BLOCK):
        raise ValueError(f"{KERNEL}: a closest part of {n_closest} of {n} "
                         f"lanes is not whole blocks of {BLOCK}")
    if ordered and n_closest != n:
        raise ValueError(f"{KERNEL}: the ordered walk is closest-hit only")
    closest = (torch.empty(n_closest, dtype=torch.float32, device=dev),
               torch.empty(n_closest, dtype=torch.int32, device=dev),
               torch.empty(n_closest, dtype=torch.float32, device=dev),
               torch.empty(n_closest, dtype=torch.float32, device=dev))
    blocked = torch.empty(n - n_closest, dtype=torch.bool, device=dev)
    if n == 0:
        return closest, blocked
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rptr_traverse_streamed(
            bb.top_nodes.data_ptr(), bb.num_top_nodes, bb.sub_nodes.data_ptr(),
            bb.tri_tiles.data_ptr(), bb.sub_node_rows, bb.sub_leaves,
            rays.data_ptr(), n, -(-n_closest // BLOCK), int(bb.quantized),
            int(ordered),
            *(x.data_ptr() or None for x in (*closest, blocked)), stream,
        )
    if rc != 0:
        msg = lib.rptr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{KERNEL} launch failed: {msg} (cudaError {rc})")
    launches_k4 += 1
    launches_k4_ordered += int(ordered)
    return closest, blocked


def launch(bb: StreamedBVHBuffers, rays: torch.Tensor, any_hit: bool,
           ordered: bool = False):
    """One K4 launch over a packed (8, N) operand in one mode. Returns the
    raw output tensors: (t, row, u, v) or the blocked flags."""
    closest, blocked = _launch(bb, rays, 0 if any_hit else rays.shape[1],
                               ordered)
    return blocked if any_hit else closest


def merged_plain(bb: StreamedBVHBuffers, rays: torch.Tensor, n_closest: int):
    """The plain version of a merged K4 launch: ``plain`` closest on lanes
    [0, n_closest), ``plain`` any-hit on the rest. Returns ((t, row, u, v),
    blocked)."""
    return (plain(bb, rays[:, :n_closest], False),
            plain(bb, rays[:, n_closest:], True))


def merged_launch(bb: StreamedBVHBuffers, rays: torch.Tensor, n_closest: int):
    """One merged K4 launch; returns what ``merged_plain`` returns."""
    global merged_launches_k4
    out = _launch(bb, rays.contiguous(), n_closest)
    merged_launches_k4 += 1
    return out


def traverse_rays(bb: StreamedBVHBuffers, rays: torch.Tensor, any_hit: bool,
                  ordered: bool = False):
    """K4 on a packed operand: ``plain`` on the CPU, the kernel on a card."""
    if rays.device.type == "cpu":
        return plain(bb, rays, any_hit, ordered)
    if rays.device.type == "cuda":
        return launch(bb, rays.contiguous(), any_hit, ordered)
    raise ValueError(f"no traversal for device {rays.device}")


# ---------------------------------------------------------------------------
# Coherence order (traverse_stream.py:851-920). u32 keys ride int64 tensors.
# ---------------------------------------------------------------------------


def _coherence_key(bb: StreamedBVHBuffers, comps):
    """u32 key of the binned dispatch (as int64): the direction octant in
    bits 21-23 and a 21-bit origin morton code over a 128^3 grid of the top
    root box in bits 0-20."""
    live = torch.ones_like(comps[0], dtype=torch.bool)
    return coherence_key(*comps, live, bb.top_nodes[0, 0:3], bb.top_nodes[0, 3:6])


def coherence_order(key, dead):
    """Stable argsort of ``key`` with dead lanes last (bit 31). Returns
    (perm, inverse perm)."""
    perm = torch.argsort(key | (dead.to(torch.int64) << 31), stable=True)
    return perm, inverse_permutation(perm)


def _sort_operand(bb: StreamedBVHBuffers, rays):
    """Coherence-sort a packed (8, N) operand by ``_coherence_key2`` over
    the top root box (dead and padding lanes last). Returns (rays_sorted,
    inv); ``out[..., inv]`` restores the caller's order."""
    key = _coherence_key2(rays, bb.top_nodes[0, 0:3], bb.top_nodes[0, 3:6])
    perm = torch.argsort(key, stable=True)
    return rays[:, perm], inverse_permutation(perm)


def _out_to_hit(bb: StreamedBVHBuffers, out, n: int, map_tri: bool) -> Hit:
    """Kernel output (t, row, u, v) -> Hit of the first ``n`` lanes;
    ``map_tri`` maps global rows to source triangles (-1 stays -1)."""
    t, row, u, v = (x[:n] for x in out)
    if map_tri:
        tri = torch.where(row < 0, -1, bb.row_tri[torch.clamp(row, min=0).long()])
        row = tri.to(torch.int32)
    return Hit(t=t, tri=row, u=u, v=v)


def closest_hit_streamed(bb: StreamedBVHBuffers, ro: Vec3, rd: Vec3,
                         t_min=0.0, t_max=T_MAX, block: int = DEFAULT_BLOCK,
                         map_tri: bool = True, sort: bool = False,
                         ordered: bool = False) -> Hit:
    """K4 closest hit. ``tri`` is the source triangle (``map_tri``) or the
    global row. ``sort`` coherence-sorts the lanes first; the result is
    the same, in the caller's lane order. ``ordered`` visits each ray's
    subtrees nearest first (the reference's ``ordered``, per ray)."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    if sort:
        rays, inv = _sort_operand(bb, rays)
    out = traverse_rays(bb, rays, any_hit=False, ordered=ordered)
    if sort:
        out = tuple(x[inv] for x in out)
    return _out_to_hit(bb, out, n, map_tri)


def occluded_streamed(bb: StreamedBVHBuffers, ro: Vec3, rd: Vec3, t_min=0.0,
                      t_max=T_MAX, block: int = DEFAULT_BLOCK,
                      sort: bool = False) -> torch.Tensor:
    """K4 any-hit visibility: True where (t_min, t_max) is blocked."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    if sort:
        rays, inv = _sort_operand(bb, rays)
    blocked = traverse_rays(bb, rays, any_hit=True)
    if sort:
        blocked = blocked[inv]
    return blocked[:n]


def closest_and_occluded_streamed(bb: StreamedBVHBuffers, comps_c, tmin_c,
                                  tmax_c, comps_s, tmin_s, tmax_s,
                                  block: int = DEFAULT_BLOCK,
                                  map_tri: bool = True, sort: bool = False):
    """K4's merged mode (closest_and_occluded_streamed, :967): the closest
    hits of one queue and the any-hit flags of another in ONE launch,
    through ``traverse_resident.merged``; ``sort`` coherence-sorts each
    half on its own, and each is unsorted before it is cut to its caller's
    lanes. Returns (Hit of the closest queue, ``tri`` mapped as
    ``closest_hit_streamed`` maps it, blocked flags)."""
    out, blocked = merged(
        comps_c, tmin_c, tmax_c, comps_s, tmin_s, tmax_s, block,
        (lambda r: _sort_operand(bb, r)) if sort else None,
        lambda r, k: merged_plain(bb, r, k),
        lambda r, k: merged_launch(bb, r, k))
    return _out_to_hit(bb, out, out[0].shape[0], map_tri), blocked
