"""Streamed two-level traversal: the K7 kernel's pack, wrappers and plain
version.

Counterpart of the reference's ``ops/traverse_tlas_stream.py``: instanced
scenes past K6's caps. Each unique mesh is chunked in OBJECT space into
subtrees of at most ``chunk_tris`` triangles (``_split_chunks``, as the
streamed pack does), and each chunk's node block and leaf tiles are stored
once (``pack_tlas_stream_static``). An ENTRY is an (instance, chunk) pair;
each frame (``pack_tlas_stream_frame``) transforms the chunk boxes to world
space, threads a top tree over the entry boxes (``_build_top_tree``) and
writes the entry table:

- ``top_nodes`` (Mt, 8) f32: [min3, max3, skip, entry id or -1], links as
  float values;
- ``entry_table`` (E, 16) f32: A^-1 (9), its translation (3),
  sigma_min(A), the chunk's first ``sub_nodes`` row and first ``tri_tiles``
  row (exact ints as values), a spare;
- ``sub_nodes`` (C*R, 128) f32 and ``tri_tiles`` (C*L*16, 128) f32: chunk
  c owns node rows [c*R, (c+1)*R) and tile rows [c*L*16, (c+1)*L*16), in
  the layout of ``traverse_stream.pack_streamed`` (local links, ``SUB_EXIT``);
- ``chunk_rowtri`` (C*chunk_tris,) i32: chunk row -> mesh-local triangle.

K7 (``closest_hit_tlas_stream`` / ``occluded_tlas_stream``; reference
``_kernel_tlas_stream``) walks the top tree per ray in preorder with the
slab test capped at its best hit; at an entered entry it takes the ray to
object space by the instance's A^-1 (direction not renormalised: object t
is world t) and walks the chunk's subtree with the segment [tmin, t_best].
Rows are ``entry * chunk_tris + leaf * 128 + k``, so one int32 names the
entry (so the instance) and the chunk row (``check_rows`` holds them to
int32). The first visited triangle keeps an exact-t tie (entries in
top-tree preorder). ``plain`` implements this with the port's plain
threaded walk, and ``csrc/traverse_tlas_stream.cu`` must equal it bitwise.

The reference caps a scene at 2,048 entries, the size of its SMEM entry
table (traverse_tlas_stream.py:82), and walks past it with XLA code. That
is a TPU limit: the CUDA kernel (K6's walk, ``csrc/tlas_walk.cuh``) has
each block stage the top tree in shared memory or reads it from global
memory, at any size. The launcher picks the placement by the top tree's
bytes with K6's rule (``traverse_tlas.top_staged``) unless ``staged``
forces one, and runs ``traverse_tlas.THREADS`` threads per block unless
``threads`` says otherwise; ``launches_k7_global`` counts the global-mode
launches.

On a CPU tensor the wrappers run ``plain``; on a CUDA tensor they launch
the kernel (built by ``kernels/build.py`` at first use) or raise.
``launches_k7`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas
from realtimepathtracingresearchframework_tpu_torch.ops.bvh import build_threaded_bvh
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu_torch.ops.tlas import (
    TwoLevelHit,
    _up,
    sweep,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    ResidentBVH,
    real_row_counts,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    _check,
    _coherence_key2,
    inverse_permutation,
    pack_rays,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_stream import (
    LEAF,
    SUB_EXIT,
    _build_top_tree,
    _split_chunks,
    node_rows_for,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

KERNEL = "traverse_tlas_stream"  # csrc/traverse_tlas_stream.cu
DEFAULT_BLOCK = 512
INT32_MAX = 2**31 - 1

launches_k7 = 0  # K7 launches in this process (reset with reset_launches)
launches_k7_global = 0  # of which read the top tree from global memory


def reset_launches() -> None:
    global launches_k7, launches_k7_global
    launches_k7 = launches_k7_global = 0


class TlasStreamStatic(NamedTuple):
    """Per-scene chunk blocks (built once; animation never touches them):
    tensors on one device, the chunk bookkeeping host numpy."""

    sub_nodes: torch.Tensor  # (C*R, 128) f32 per-chunk node blocks
    tri_tiles: torch.Tensor  # (C*L*16, 128) f32 object-space tiles
    chunk_rowtri: torch.Tensor  # (C*chunk_tris,) i32 mesh-local tri
    chunk_mesh: np.ndarray  # (C,) i32
    chunk_node_base: np.ndarray  # (C,) i32 first sub_nodes row
    chunk_tile_base: np.ndarray  # (C,) i32 first tri_tiles row
    chunk_obj_min: np.ndarray  # (C, 3) f32
    chunk_obj_max: np.ndarray  # (C, 3) f32
    mesh_chunk_start: np.ndarray  # (num_meshes + 1,) i32
    chunk_tris: int

    @property
    def sub_leaves(self) -> int:
        return self.chunk_tris // LEAF

    @property
    def node_rows(self) -> int:
        return node_rows_for(self.sub_leaves)

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_mesh)


class TlasStreamFrame(NamedTuple):
    """One frame's top tree, entry table and entry -> shading maps."""

    top_nodes: torch.Tensor  # (Mt, 8) f32: min3, max3, skip, entry | -1
    entry_table: torch.Tensor  # (E, 16) f32
    entry_chunk: torch.Tensor  # (E,) i32
    entry_inst: torch.Tensor  # (E,) i32
    entry_tri_base: torch.Tensor  # (E,) i32 global shading-row base

    @property
    def num_top_nodes(self) -> int:
        return self.top_nodes.shape[0]

    @property
    def num_entries(self) -> int:
        return self.entry_table.shape[0]


def pick_chunk_tris(mesh_sizes) -> int:
    """Chunk size of an instanced scene (traverse_tlas_stream.py:133-139):
    the largest mesh in whole leaves, never below 1024 and never above
    8192. Not ``traverse_stream.pick_chunk_tris``, which takes one
    triangle count."""
    biggest = int(max(mesh_sizes)) if len(mesh_sizes) else 1
    per = -(-biggest // LEAF) * LEAF
    return int(min(max(per, 1024), 8192))


def chunk_count(num_tris: int, chunk_tris: int) -> int:
    """Chunks ``_split_chunks`` makes of a mesh of ``num_tris`` triangles:
    its split sizes depend on the count alone, so the entry count of a
    scene is known before any chunk is built."""
    if num_tris <= chunk_tris:
        return 1
    half = (num_tris // 2 + chunk_tris - 1) // chunk_tris * chunk_tris
    half = min(max(half, chunk_tris), num_tris - 1)
    return chunk_count(half, chunk_tris) + chunk_count(num_tris - half,
                                                       chunk_tris)


def entry_count(mesh_sizes, mesh_ids, chunk_tris: int = None) -> int:
    """(instance, chunk) entries of a scene, without packing it."""
    if chunk_tris is None:
        chunk_tris = pick_chunk_tris(mesh_sizes)
    per_mesh = np.asarray([chunk_count(int(n), chunk_tris) for n in mesh_sizes])
    return int(per_mesh[np.asarray(mesh_ids, np.int64)].sum())


def check_rows(num_entries: int, chunk_tris: int) -> None:
    """K7's rows ``entry * chunk_tris + leaf * 128 + k`` must fit int32."""
    if num_entries * chunk_tris - 1 > INT32_MAX:
        raise ValueError(
            f"{num_entries} (instance, chunk) entries of {chunk_tris}-tri "
            "chunks: K7's rows (entry * chunk_tris + chunk row) overflow int32")


def pack_tlas_stream_static(mesh_tris: List, chunk_tris: int = None,
                            device="cpu") -> TlasStreamStatic:
    """Chunk, build and pack every unique mesh's object-space BLAS into
    streamed blocks (traverse_tlas_stream.py:142-216), uploaded to
    ``device``."""
    if chunk_tris is None:
        chunk_tris = pick_chunk_tris([len(m[0]) for m in mesh_tris])
    assert chunk_tris % LEAF == 0 and chunk_tris > 0
    sub_leaves = chunk_tris // LEAF
    node_rows = node_rows_for(sub_leaves)
    if node_rows * 16 > SUB_EXIT:
        raise ValueError(f"{chunk_tris} tris per chunk: node slots reach "
                         f"the SUB_EXIT sentinel {SUB_EXIT}")
    tile_rows = sub_leaves * 16

    nodes_l, tiles_l, rowtri_l = [], [], []
    chunk_mesh, node_base, tile_base = [], [], []
    obj_min, obj_max = [], []
    mesh_chunk_start = [0]
    for mid, (v0, e1, e2) in enumerate(mesh_tris):
        v0 = np.asarray(v0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        v1, v2 = v0 + e1, v0 + e2
        tmin = np.minimum(np.minimum(v0, v1), v2)
        tmax = np.maximum(np.maximum(v0, v1), v2)
        centroid = 0.5 * (tmin + tmax)
        for idx in _split_chunks(centroid, chunk_tris):
            cv0, ce1, ce2 = v0[idx], e1[idx], e2[idx]
            tb = build_threaded_bvh(cv0, ce1, ce2, leaf_size=LEAF,
                                    builder="sah")
            if (tb.num_nodes > node_rows * 16
                    or tb.tri_rows.shape[0] // LEAF > sub_leaves):
                tb = build_threaded_bvh(cv0, ce1, ce2, leaf_size=LEAF)
            nn = tb.num_nodes
            assert nn <= node_rows * 16, f"chunk subtree too big: {nn}"
            nd = tb.nodes.copy()
            skip = nd[:, 6].view(np.int32).copy()
            leaf_row = nd[:, 7].view(np.int32).copy()
            skip[skip >= nn] = SUB_EXIT
            is_leaf = leaf_row >= 0
            leaf_row[is_leaf] = leaf_row[is_leaf] // LEAF
            nd[:, 6] = skip.astype(np.float32)
            nd[:, 7] = leaf_row.astype(np.float32)
            nblock = np.zeros((node_rows, 128), np.float32)
            nblock.reshape(-1)[: nn * 8] = nd.reshape(-1)
            nodes_l.append(nblock)
            rows = tb.tri_rows
            nl = rows.shape[0] // LEAF
            tiles = np.zeros((sub_leaves, 16, 128), np.float32)
            tiles[:nl, 0:9, :] = rows[:, 0:9].reshape(nl, LEAF, 9).transpose(0, 2, 1)
            tiles_l.append(tiles.reshape(tile_rows, 128))
            rt = np.zeros(chunk_tris, np.int32)
            rt[:rows.shape[0]] = idx[tb.row_tri].astype(np.int32)
            rowtri_l.append(rt)
            chunk_mesh.append(mid)
            node_base.append((len(nodes_l) - 1) * node_rows)
            tile_base.append((len(tiles_l) - 1) * tile_rows)
            obj_min.append(tb.world_min)
            obj_max.append(tb.world_max)
        mesh_chunk_start.append(len(chunk_mesh))

    return TlasStreamStatic(
        sub_nodes=_up(np.concatenate(nodes_l, axis=0), device),
        tri_tiles=_up(np.concatenate(tiles_l, axis=0), device),
        chunk_rowtri=_up(np.concatenate(rowtri_l), device),
        chunk_mesh=np.asarray(chunk_mesh, np.int32),
        chunk_node_base=np.asarray(node_base, np.int32),
        chunk_tile_base=np.asarray(tile_base, np.int32),
        chunk_obj_min=np.stack(obj_min).astype(np.float32),
        chunk_obj_max=np.stack(obj_max).astype(np.float32),
        mesh_chunk_start=np.asarray(mesh_chunk_start, np.int32),
        chunk_tris=chunk_tris,
    )


def pack_tlas_stream_frame(static: TlasStreamStatic, mesh_ids, transforms,
                           tri_base) -> TlasStreamFrame:
    """One frame's TLAS side (traverse_tlas_stream.py:219-273): expand the
    instances into (instance, chunk) entries, transform the chunk boxes to
    world space, thread a top tree over them. Host numpy; the tensors go to
    the static pack's device, whose tensors stay untouched."""
    dev = static.sub_nodes.device
    mesh_ids = np.asarray(mesh_ids, np.int64)
    xf = np.asarray(transforms, np.float64)  # (I, 3, 4)
    A = xf[:, :, :3]
    t = xf[:, :, 3]
    Ainv = np.linalg.inv(A)
    tinv = -np.einsum("iab,ib->ia", Ainv, t)
    cull_scale = np.linalg.svd(A, compute_uv=False)[:, -1]

    start = static.mesh_chunk_start
    counts = (start[1:] - start[:-1])[mesh_ids]  # chunks per instance
    entry_inst = np.repeat(np.arange(len(mesh_ids), dtype=np.int32), counts)
    offs = np.concatenate([[0], np.cumsum(counts)])
    entry_chunk = (
        np.arange(offs[-1], dtype=np.int64)
        - np.repeat(offs[:-1], counts)
        + np.repeat(start[:-1][mesh_ids], counts)
    ).astype(np.int32)
    E = len(entry_chunk)

    # world AABBs of entries: affine image of the chunk object box
    bmin = static.chunk_obj_min[entry_chunk]
    bmax = static.chunk_obj_max[entry_chunk]
    Ae = A[entry_inst].astype(np.float32)
    te = t[entry_inst].astype(np.float32)
    ctr = 0.5 * (bmin + bmax)
    ext = 0.5 * (bmax - bmin)
    wctr = np.einsum("eab,eb->ea", Ae, ctr) + te
    wext = np.einsum("eab,eb->ea", np.abs(Ae), ext)
    emin = (wctr - wext).astype(np.float32)
    emax = (wctr + wext).astype(np.float32)

    top = _build_top_tree(emin, emax)

    et = np.zeros((E, 16), np.float32)
    et[:, 0:9] = Ainv[entry_inst].reshape(E, 9).astype(np.float32)
    et[:, 9:12] = tinv[entry_inst].astype(np.float32)
    et[:, 12] = cull_scale[entry_inst].astype(np.float32)
    et[:, 13] = static.chunk_node_base[entry_chunk].astype(np.float32)
    et[:, 14] = static.chunk_tile_base[entry_chunk].astype(np.float32)

    check_rows(E, static.chunk_tris)
    tri_base = np.asarray(tri_base, np.int32)
    return TlasStreamFrame(
        top_nodes=_up(top, dev),
        entry_table=_up(et, dev),
        entry_chunk=_up(entry_chunk, dev),
        entry_inst=_up(entry_inst, dev),
        entry_tri_base=_up(tri_base[mesh_ids][entry_inst], dev),
    )


def chunk_resident(static: TlasStreamStatic, node_base: int,
                   tile_base: int) -> ResidentBVH:
    """One chunk decoded to the resident layout of the plain walk: node
    boxes, integer links (``SUB_EXIT`` lies past the last slot, so the walk
    leaves there) and its tiles as (L*128, 9) rows, whose index is the
    chunk row ``leaf*128 + k``."""
    slots = static.node_rows * 16
    nodes = static.sub_nodes[node_base:node_base + static.node_rows].view(slots, 8)
    L = static.sub_leaves
    tiles = static.tri_tiles[tile_base:tile_base + L * 16].view(L, 16, LEAF)
    rows = tiles[:, 0:9, :].transpose(1, 2).reshape(L * LEAF, 9)
    return ResidentBVH(
        bounds=nodes[:, 0:6],
        links=nodes[:, 6:8].to(torch.int32),
        tri_rows=rows,
        row_tri=static.chunk_rowtri[:0],
        leaf_size=LEAF,
        real_rows=real_row_counts(rows, LEAF),
    )


def leaf_boxes(static: TlasStreamStatic, fr: TlasStreamFrame):
    """Per chunk node row (the entry table's column 13), the object-space
    boxes (K, 6) of the chunk's leaf nodes: the leaves K7's bound counts."""
    slots = static.node_rows * 16
    out = {}
    for base in {int(b) for b in fr.entry_table[:, 13].tolist()}:
        nodes = static.sub_nodes[base:base + static.node_rows].view(slots, 8)
        # a real node's skip link lies past it; unused slots are all zero
        out[base] = nodes[(nodes[:, 7] >= 0) & (nodes[:, 6] > 0), 0:6]
    return out


# ---------------------------------------------------------------------------
# Plain version of K7 and the kernel launch
# ---------------------------------------------------------------------------


def plain(static: TlasStreamStatic, fr: TlasStreamFrame, rays: torch.Tensor,
          any_hit: bool):
    """The plain version of K7 on a packed (8, N) operand: what the
    wrappers run on CPU tensors, and what ``launch`` must equal on the
    card: ``tlas.sweep`` over the top tree, each entered entry walking its
    chunk (``chunk_resident``) by the entry table's inverse affine. Returns
    (t, row, u, v) with rows ``entry * chunk_tris + chunk row``, or the
    blocked flags."""
    top = fr.top_nodes.cpu().numpy().astype(np.int64)
    table = fr.entry_table.tolist()
    cache = {}

    def enter(eid):
        row = table[eid]
        key = (int(row[13]), int(row[14]))
        if key not in cache:
            cache[key] = chunk_resident(static, *key)
        return cache[key], row, eid * static.chunk_tris, eid

    out = sweep(fr.top_nodes[:, 0:6], top[:, 6], top[:, 7], rays, any_hit,
                enter)
    return out if any_hit else out[:4]


def _lib():
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    lib = build.load(KERNEL)
    # every pointer and the stream as c_void_p (a bare Python int would be
    # passed as a 32-bit C int and cut the pointer)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rptr_traverse_tlas_stream.argtypes = (
        [p, i, p, p, p, i, i, p, i, i, i, i] + [p] * 5 + [p])
    lib.rptr_traverse_tlas_stream.restype = ctypes.c_int
    lib.rptr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rptr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_buffers(static: TlasStreamStatic, fr: TlasStreamFrame, dev) -> None:
    """Device, type, shape and contiguity of K7's operands."""
    c, R, L = static.num_chunks, static.node_rows, static.sub_leaves
    _check("top_nodes", fr.top_nodes, torch.float32, (fr.num_top_nodes, 8), dev)
    _check("entry_table", fr.entry_table, torch.float32, (fr.num_entries, 16), dev)
    _check("sub_nodes", static.sub_nodes, torch.float32, (c * R, 128), dev)
    _check("tri_tiles", static.tri_tiles, torch.float32, (c * L * 16, 128), dev)
    if R * 16 > SUB_EXIT:
        raise ValueError(f"{L} leaves per chunk: too many node slots")
    traverse_tlas.check_aligned(top_nodes=fr.top_nodes,
                                sub_nodes=static.sub_nodes,
                                tri_tiles=static.tri_tiles)


def top_bytes(fr: TlasStreamFrame) -> int:
    """The shared memory a block needs to stage the frame's top tree."""
    return fr.top_nodes.numel() * fr.top_nodes.element_size()


def launch(static: TlasStreamStatic, fr: TlasStreamFrame, rays: torch.Tensor,
           any_hit: bool, staged: bool = None, threads: int = None):
    """One K7 launch over a packed (8, N) operand, one lane per ray.
    ``staged``: each block stages the top tree in shared memory (True) or
    the kernel reads it from global memory (False); None picks by size
    (``traverse_tlas.top_staged``). ``threads`` per block (a multiple of 32
    up to 512): ``traverse_tlas.THREADS`` by default. Returns the raw output
    tensors: (t, row, u, v) or the blocked flags."""
    global launches_k7, launches_k7_global
    dev = rays.device
    n = rays.shape[1]
    check_buffers(static, fr, dev)
    check_rows(fr.num_entries, static.chunk_tris)
    _check("rays", rays, torch.float32, (8, n), dev)
    if any_hit:
        blocked = torch.empty(n, dtype=torch.bool, device=dev)
        outs = (None, None, None, None, blocked.data_ptr())
        result = blocked
    else:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        row = torch.empty(n, dtype=torch.int32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
        outs = (t.data_ptr(), row.data_ptr(), u.data_ptr(), v.data_ptr(), None)
        result = (t, row, u, v)
    if n == 0:
        return result
    lib = _lib()
    if staged is None:
        staged = traverse_tlas.top_staged(top_bytes(fr))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rptr_traverse_tlas_stream(
            fr.top_nodes.data_ptr(), fr.num_top_nodes,
            fr.entry_table.data_ptr(), static.sub_nodes.data_ptr(),
            static.tri_tiles.data_ptr(), static.node_rows, static.sub_leaves,
            rays.data_ptr(), n, int(any_hit), int(not staged),
            threads or traverse_tlas.THREADS, *outs, stream,
        )
    if rc != 0:
        msg = lib.rptr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{KERNEL} launch failed: {msg} (cudaError {rc})")
    launches_k7 += 1
    launches_k7_global += int(not staged)
    return result


def traverse_rays(static: TlasStreamStatic, fr: TlasStreamFrame,
                  rays: torch.Tensor, any_hit: bool):
    """K7 on a packed operand: ``plain`` on the CPU, the kernel on a card."""
    if rays.device.type == "cpu":
        return plain(static, fr, rays, any_hit)
    if rays.device.type == "cuda":
        return launch(static, fr, rays.contiguous(), any_hit)
    raise ValueError(f"no traversal for device {rays.device}")


def _sort_operand(fr: TlasStreamFrame, rays):
    """Coherence-sort a packed (8, N) operand against the frame's top-tree
    root box (traverse_tlas_stream.py:557-567). Returns (rays_sorted, inv);
    ``out[..., inv]`` restores the caller's order."""
    key = _coherence_key2(rays, fr.top_nodes[0, 0:3], fr.top_nodes[0, 3:6])
    perm = torch.argsort(key, stable=True)
    return rays[:, perm], inverse_permutation(perm)


def out_to_hit(static: TlasStreamStatic, fr: TlasStreamFrame, out,
               n: int) -> TwoLevelHit:
    """Kernel output (t, row, u, v) -> TwoLevelHit of the first ``n`` lanes,
    decoded through the entry (traverse_tlas_stream.py:592-604)."""
    t, row, u, v = (x[:n] for x in out)
    miss = row < 0
    rw = torch.clamp(row, min=0).long()
    entry = rw // static.chunk_tris
    local = rw % static.chunk_tris
    tri_local = static.chunk_rowtri[
        fr.entry_chunk[entry].long() * static.chunk_tris + local]
    tri = torch.where(miss, -1, fr.entry_tri_base[entry] + tri_local)
    inst = torch.where(miss, -1, fr.entry_inst[entry])
    return TwoLevelHit(t=t, tri=tri.to(torch.int32), u=u, v=v,
                       inst=inst.to(torch.int32))


def closest_hit_tlas_stream(static: TlasStreamStatic, fr: TlasStreamFrame,
                            ro: Vec3, rd: Vec3, t_min=0.0, t_max=T_MAX,
                            block: int = DEFAULT_BLOCK,
                            sort: bool = False) -> TwoLevelHit:
    """K7 closest hit with global shading rows and instance ids. ``sort``
    coherence-sorts the lanes first; the result is the same, in the
    caller's lane order."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    if sort:
        rays, inv = _sort_operand(fr, rays)
    out = traverse_rays(static, fr, rays, any_hit=False)
    if sort:
        out = tuple(x[inv] for x in out)
    return out_to_hit(static, fr, out, n)


def occluded_tlas_stream(static: TlasStreamStatic, fr: TlasStreamFrame,
                         ro: Vec3, rd: Vec3, t_min=0.0, t_max=T_MAX,
                         block: int = DEFAULT_BLOCK,
                         sort: bool = False) -> torch.Tensor:
    """K7 any-hit visibility: True where (t_min, t_max) is blocked."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    if sort:
        rays, inv = _sort_operand(fr, rays)
    blocked = traverse_rays(static, fr, rays, any_hit=True)
    if sort:
        blocked = blocked[inv]
    return blocked[:n]
