"""Two-level acceleration structure: an object-space BLAS per unique mesh
and a TLAS over the instances.

Counterpart of the reference's ``ops/tlas.py`` (its own copy: the
reference imports jax). The host builders are numpy and return numpy, or
torch tensors on an explicit device:

- ``build_blas_set``: one threaded BLAS of 4-triangle leaves per unique
  mesh, in object space, concatenated (node links BLAS-local);
- ``instance_world_aabbs``: the world box of each instance, from the 8
  transformed corners of its BLAS root box;
- ``build_tlas_nodes``: the TLAS, the same threaded structure built over
  the instance boxes as degenerate "triangles" (v0 = min, e1 = max - min,
  e2 = centre - min) with one triangle per leaf; ``row_inst`` maps a leaf
  row to its instance;
- ``build_instance_tables``: per-instance inverse affine, linear part A,
  normal transform A^-T, scales, handedness, material offset and BLAS
  ranges.

``closest_hit_two_level`` / ``occluded_two_level`` are the nested walk:
every ray threads the TLAS; at an instance leaf it is taken to object space
by the instance's inverse affine WITHOUT renormalising the direction
(d_o = A^-1 d_w), so object-space t is world t, the segment [tmin, t_best]
passes through unchanged and hits of different instances compare directly.
The walk of one instance's BLAS is the port's plain threaded walk
(``ops/traverse.py::walk_ranges``). This is the CPU oracle that K6
(``ops/traverse_tlas.py``) and K7 (``ops/traverse_tlas_stream.py``) are held
to across kernels; it is never a route on the card. ``sweep``, the walk
over any top tree, is also the core of K6's and K7's plain versions, and
``ordered_sweep``, the nearest-first walk over a top tree, that of K4's and
K6's ordered walks.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops.bvh import (
    LEAF_SIZE,
    build_threaded_bvh,
)
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import (
    T_MAX,
    ray_aabb,
    safe_inv_dir,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    ResidentBVH,
    real_row_counts,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    pack_rays,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3


class TwoLevelHit(NamedTuple):
    t: torch.Tensor  # T_MAX on miss
    tri: torch.Tensor  # i32 global shading row (inst tri base + mesh tri), -1
    u: torch.Tensor
    v: torch.Tensor
    inst: torch.Tensor  # i32 instance id, -1 on miss

    @property
    def valid(self):
        return self.tri >= 0


class TwoLevelBuffers(NamedTuple):
    """The nested walk's tables and the instance attribute transforms, on
    one device."""

    tlas_nodes: torch.Tensor  # (Mt, 8) f32 threaded; links as int32 bits
    tlas_row_inst: torch.Tensor  # (Lt,) i32 leaf row -> instance id
    inst_inv: torch.Tensor  # (I, 12) object_from_world affine (3x4 rows)
    inst_linear: torch.Tensor  # (I, 9) world_from_object linear A
    inst_inv_t: torch.Tensor  # (I, 9) A^-T (normal transform)
    inst_scale: torch.Tensor  # (I,) cbrt|det A| (texel-density scale)
    inst_cull_scale: torch.Tensor  # (I,) sigma_min(A)
    inst_sign: torch.Tensor  # (I,) sign(det A)
    inst_mesh: torch.Tensor  # (I,) i32
    inst_mat_offset: torch.Tensor  # (I,) i32
    inst_node_start: torch.Tensor  # (I,) i32 BLAS node range start
    inst_node_count: torch.Tensor  # (I,) i32
    inst_row_start: torch.Tensor  # (I,) i32 BLAS tri-row offset
    inst_tri_base: torch.Tensor  # (I,) i32 global shading-row base
    blas_nodes: torch.Tensor  # (Mb, 8) f32, links BLAS-local int32 bits
    blas_tri_rows: torch.Tensor  # (R, 12) f32 object space
    blas_row_tri: torch.Tensor  # (R,) i32 mesh-local tri


class BlasSet(NamedTuple):
    """Host-side concatenated BLAS arrays (built once per scene)."""

    nodes: np.ndarray
    tri_rows: np.ndarray
    row_tri: np.ndarray
    node_start: np.ndarray  # (num_meshes,)
    node_count: np.ndarray
    row_start: np.ndarray
    tri_base: np.ndarray  # global shading-row base per mesh
    root_min: np.ndarray  # (num_meshes, 3) object-space root AABB
    root_max: np.ndarray


def _up(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_blas_set(mesh_tris: List) -> BlasSet:
    """``mesh_tris``: (v0, e1, e2) object-space arrays per unique mesh
    (tlas.py:101-133)."""
    nodes, rows, row_tri = [], [], []
    node_start, node_count, row_start, tri_base = [], [], [], []
    root_min, root_max = [], []
    n_off = r_off = t_off = 0
    for v0, e1, e2 in mesh_tris:
        tb = build_threaded_bvh(v0, e1, e2, leaf_size=LEAF_SIZE)
        nodes.append(tb.nodes)
        rows.append(tb.tri_rows)
        row_tri.append(tb.row_tri)
        node_start.append(n_off)
        node_count.append(tb.nodes.shape[0])
        row_start.append(r_off)
        tri_base.append(t_off)
        root_min.append(tb.world_min)
        root_max.append(tb.world_max)
        n_off += tb.nodes.shape[0]
        r_off += tb.tri_rows.shape[0]
        t_off += len(v0)
    return BlasSet(
        nodes=np.concatenate(nodes),
        tri_rows=np.concatenate(rows),
        row_tri=np.concatenate(row_tri).astype(np.int32),
        node_start=np.asarray(node_start, np.int32),
        node_count=np.asarray(node_count, np.int32),
        row_start=np.asarray(row_start, np.int32),
        tri_base=np.asarray(tri_base, np.int32),
        root_min=np.stack(root_min),
        root_max=np.stack(root_max),
    )


def instance_world_aabbs(blas: BlasSet, mesh_ids, transforms) -> np.ndarray:
    """(I, 2, 3) world AABBs: the 8 transformed corners of each BLAS root
    box (tlas.py:136-148)."""
    mesh_ids = np.asarray(mesh_ids, np.int64)
    xf = np.asarray(transforms, np.float32)  # (I, 3, 4)
    bmin = blas.root_min[mesh_ids]
    bmax = blas.root_max[mesh_ids]
    corners = np.empty((len(mesh_ids), 8, 3), np.float32)
    for k in range(8):
        sel = np.array([(k >> j) & 1 for j in range(3)], bool)
        corners[:, k] = np.where(sel, bmax, bmin)
    wc = np.einsum("iab,ikb->ika", xf[:, :, :3], corners) + xf[:, None, :, 3]
    return np.stack([wc.min(axis=1), wc.max(axis=1)], axis=1)


def build_tlas_nodes(aabbs: np.ndarray):
    """Threaded TLAS over instance AABBs (I, 2, 3) by the degenerate
    triangle trick (tlas.py:151-158); returns (nodes (Mt, 8), row_inst
    (Lt,))."""
    amin = aabbs[:, 0]
    amax = aabbs[:, 1]
    mid = 0.5 * (amin + amax)
    tb = build_threaded_bvh(amin, amax - amin, mid - amin, leaf_size=1)
    return tb.nodes, tb.row_tri.astype(np.int32)


def build_instance_tables(blas: BlasSet, mesh_ids, mat_offsets, transforms,
                          device="cpu") -> dict:
    """Per-instance tables (tlas.py:161-193) as tensors on ``device``:
    inverse affine, linear part, normal transform, scales, sign, material
    offset and BLAS ranges."""
    mesh_ids = np.asarray(mesh_ids, np.int64)
    xf = np.asarray(transforms, np.float64)  # (I, 3, 4)
    A = xf[:, :, :3]
    t = xf[:, :, 3]
    Ainv = np.linalg.inv(A)
    tinv = -np.einsum("iab,ib->ia", Ainv, t)
    det = np.linalg.det(A)
    scale = np.cbrt(np.abs(det))
    # conservative culling scale: |A^-1 d| <= 1/sigma_min for unit d
    cull_scale = np.linalg.svd(A, compute_uv=False)[:, -1]
    inv12 = np.concatenate([Ainv.reshape(-1, 9), tinv], axis=1).astype(np.float32)
    tables = dict(
        inst_inv=inv12,
        inst_linear=A.reshape(-1, 9).astype(np.float32),
        inst_inv_t=np.transpose(Ainv, (0, 2, 1)).reshape(-1, 9).astype(np.float32),
        inst_scale=scale.astype(np.float32),
        inst_cull_scale=cull_scale.astype(np.float32),
        inst_sign=np.sign(det).astype(np.float32),
        inst_mesh=mesh_ids.astype(np.int32),
        inst_mat_offset=np.asarray(mat_offsets, np.int32),
        inst_node_start=blas.node_start[mesh_ids],
        inst_node_count=blas.node_count[mesh_ids],
        inst_row_start=blas.row_start[mesh_ids],
        inst_tri_base=blas.tri_base[mesh_ids],
    )
    return {k: _up(v, device) for k, v in tables.items()}


def blas_tensors(blas: BlasSet, device="cpu") -> dict:
    """The BLAS set's arrays on ``device``, uploaded once per scene."""
    return dict(blas_nodes=_up(blas.nodes, device),
                blas_tri_rows=_up(blas.tri_rows, device),
                blas_row_tri=_up(blas.row_tri, device))


def two_level_buffers(blas_dev: dict, tlas_nodes, row_inst,
                      tables: dict) -> TwoLevelBuffers:
    """The nested walk's buffers: this frame's TLAS (host numpy, uploaded
    here) and instance tables around the scene's uploaded BLAS set
    (``blas_tensors``, the same tensors every frame)."""
    dev = blas_dev["blas_nodes"].device
    return TwoLevelBuffers(
        tlas_nodes=_up(np.asarray(tlas_nodes, np.float32), dev),
        tlas_row_inst=_up(np.asarray(row_inst, np.int32), dev),
        **blas_dev, **tables,
    )


# ---------------------------------------------------------------------------
# Object rays and the nested walk (tlas.py:201-344)
# ---------------------------------------------------------------------------


def object_ray(a, ro: Vec3, rd: Vec3):
    """World ray -> object ray by an instance's inverse affine ``a`` (12,
    rows of A^-1 then its translation), the direction NOT renormalised, in
    the reference kernel's expression order (traverse_tlas.py:246-251):
    ``ox = a0*rox + a1*roy + a2*roz + t0``. The CUDA kernels evaluate the
    same sums in the same order without FMA contraction."""
    o = Vec3(*(a[3 * k] * ro.x + a[3 * k + 1] * ro.y + a[3 * k + 2] * ro.z
               + a[9 + k] for k in range(3)))
    d = Vec3(*(a[3 * k] * rd.x + a[3 * k + 1] * rd.y + a[3 * k + 2] * rd.z
               for k in range(3)))
    return o, d


def _blas_resident(tb: TwoLevelBuffers, start: int, count: int,
                   row0: int) -> ResidentBVH:
    """One BLAS of the set decoded to the resident layout of the plain walk:
    its ``count`` nodes from ``start`` (BLAS-local skip links; the last
    one equals ``count``, so the walk leaves there), leaf ids
    (leaf row // LEAF_SIZE) and its tri rows from ``row0``, whose index is
    the BLAS-local row."""
    nodes = tb.blas_nodes[start:start + count]
    links = nodes[:, 6:8].contiguous().view(torch.int32)
    leaf = torch.where(links[:, 1] >= 0, links[:, 1] // LEAF_SIZE, -1)
    rows = int(leaf.max().item() + 1) * LEAF_SIZE
    return ResidentBVH(
        bounds=nodes[:, 0:6],
        links=torch.stack([links[:, 0], leaf.to(torch.int32)], dim=1),
        tri_rows=tb.blas_tri_rows[row0:row0 + rows, 0:9],
        row_tri=tb.blas_row_tri[row0:row0 + rows],
        leaf_size=LEAF_SIZE,
        real_rows=real_row_counts(tb.blas_tri_rows[row0:row0 + rows], LEAF_SIZE),
    )


def sweep(top_boxes, skip, payload, rays, any_hit: bool, enter):
    """The plain two-level walk on a packed (8, N) operand [ro3, rd3, tmin,
    tmax], shared by the nested walk and the plain versions of K6 and K7.

    ``top_boxes`` (Mt, 6) are the top tree's node boxes; ``skip`` and
    ``payload`` (host ints) its skip links and leaf payloads, -1 on inner
    nodes. Every ray walks the top tree from node 0 in preorder with the
    slab test capped at its best hit. Top nodes are swept in ascending
    order: a ray's cursor only moves forward, so when node j is processed
    every ray whose cursor is j is there. The lanes that enter a leaf take
    the object ray (``object_ray``) of ``enter(payload)`` = (ResidentBVH,
    inverse affine a[0:12], row base, instance) and walk that BVH with the
    port's plain threaded walk (``traverse.walk_ranges``), the segment [tmin,
    t_best] in world t; a hit replaces the best only when strictly nearer,
    and records the row base + the BVH row and the instance. Returns (t,
    row, u, v, inst) with T_MAX and -1 on a miss, or the blocked flags."""
    n, dev = rays.shape[1], rays.device
    ro3 = rays[0:3].T
    inv3, zero3 = safe_inv_dir(rays[3:6].T), rays[3:6].T == 0.0
    tmin, tmax = rays[6], rays[7]
    t_best = tmax.clone()
    best_row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    mt = len(skip)
    # an empty segment (tmax <= tmin) can never hit: it walks nothing
    cur = torch.where(tmax > tmin, 0, mt)
    for j in range(mt):
        ids = torch.nonzero(cur == j).squeeze(1)
        if not ids.numel():
            continue
        box = top_boxes[j]
        hit_box, _ = ray_aabb(ro3[ids], inv3[ids], box[0:3], box[3:6],
                              tmin[ids], t_best[ids], zero3[ids])
        if payload[j] < 0:
            cur[ids] = torch.where(hit_box, j + 1, int(skip[j]))
            continue
        cur[ids] = int(skip[j])
        vi = ids[hit_box]
        if not vi.numel():
            continue
        bvh, a, row_base, inst = enter(int(payload[j]))
        o, d = object_ray(a, Vec3(*rays[0:3, vi]), Vec3(*rays[3:6, vi]))
        if any_hit:
            b = traverse.occluded_threaded(bvh, o, d, tmin[vi], t_best[vi])
            blocked[vi[b]] = True
            cur[vi[b]] = mt
            continue
        h = traverse.closest_hit_threaded(bvh, o, d, tmin[vi], t_best[vi])
        found = h.tri >= 0
        vf = vi[found]
        t_best[vf] = h.t[found]
        best_row[vf] = h.tri[found] + row_base
        best_u[vf] = h.u[found]
        best_v[vf] = h.v[found]
        best_inst[vf] = inst
    if any_hit:
        return blocked
    return (torch.where(best_row < 0, T_MAX, t_best), best_row, best_u,
            best_v, best_inst)


def top_entries(top_boxes, leaf_nodes, rays, block: int = 64):
    """(L, N) f32: ray i's entry t into the box of top node
    ``leaf_nodes[j]`` by the walk's slab test (``ray_aabb``) with t_far
    capped at its tmax, +inf where that test fails or the segment is empty
    (tmax <= tmin). The test passes at a cap c <= tmax exactly where the
    entry is <= c; boxes of the top trees contain their children's, so a
    leaf the walk could enter at cap c has every ancestor open at c too."""
    n = rays.shape[1]
    ro3 = rays[0:3].T[None]
    inv3, zero3 = safe_inv_dir(rays[3:6].T)[None], (rays[3:6].T == 0.0)[None]
    tmin, tmax = rays[6], rays[7]
    live = tmax > tmin
    out = torch.empty((len(leaf_nodes), n), dtype=torch.float32,
                      device=rays.device)
    for a in range(0, len(leaf_nodes), block):
        box = top_boxes[leaf_nodes[a:a + block]]
        hit, entry = ray_aabb(ro3, inv3, box[:, None, 0:3], box[:, None, 3:6],
                              tmin, tmax, zero3)
        out[a:a + block] = torch.where(hit & live, entry, float("inf"))
    return out


def ordered_sweep(top_boxes, payload, rays, visit):
    """The plain ordered (front-to-back) walk of a top tree, shared by the
    plain versions of K4's and K6's ordered modes: each ray visits the top
    leaves its slab test enters, nearest first, in (entry t, preorder
    index) order, each only while its entry t is within the ray's best t
    so far; the walk ends at the first leaf past it. ``visit(ids,
    payload, t_cap)`` walks those rays' leaves (each ray its own leaf's
    ``payload``) with the segment [tmin, t_cap] and returns their ``Hit``
    (global rows); a hit replaces the best only when strictly nearer. The
    kernels reach the same visit order by re-scanning the top tree for the
    least (entry, index) above the last visited one, so their results are
    bitwise these. ``payload`` (host ints) is -1 on inner nodes. Returns
    (t, row, u, v, payload of the winning leaf) with T_MAX and -1 on a
    miss."""
    n, dev = rays.shape[1], rays.device
    leaf = np.nonzero(np.asarray(payload) >= 0)[0]
    entry = top_entries(top_boxes, torch.from_numpy(leaf).to(dev), rays)
    pay = torch.from_numpy(np.asarray(payload)[leaf]).to(dev)
    rank = torch.arange(len(leaf), device=dev)[:, None]
    tmin, tmax = rays[6], rays[7]
    t_best = tmax.clone()
    best_row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    best_pay = torch.full((n,), -1, dtype=torch.int32, device=dev)
    last_e = torch.full((n,), -float("inf"), dtype=torch.float32, device=dev)
    last_j = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ids = torch.nonzero(tmax > tmin).squeeze(1)
    while ids.numel():
        e = entry[:, ids]
        le, lj = last_e[ids], last_j[ids]
        cand = ((e > le) | ((e == le) & (rank > lj))) & (e <= t_best[ids])
        e_min = torch.where(cand, e, float("inf")).amin(dim=0)
        j = torch.where(cand & (e == e_min), rank, len(leaf)).amin(dim=0)
        keep = e_min < float("inf")
        ids, e_min, j = ids[keep], e_min[keep], j[keep]
        if not ids.numel():
            break
        h = visit(ids, pay[j], t_best[ids])
        found = h.tri >= 0
        vf = ids[found]
        t_best[vf] = h.t[found]
        best_row[vf] = h.tri[found]
        best_u[vf] = h.u[found]
        best_v[vf] = h.v[found]
        best_pay[vf] = pay[j[found]].to(torch.int32)
        last_e[ids] = e_min
        last_j[ids] = j
    return (torch.where(best_row < 0, T_MAX, t_best), best_row, best_u,
            best_v, best_pay)


def _two_level(tb: TwoLevelBuffers, ro: Vec3, rd: Vec3, t_min, t_max,
               any_hit: bool):
    """The nested walk (tlas.py:201-317) by ``sweep`` over the TLAS, whose
    links are int32 bit patterns and whose leaf rows map to instances;
    each instance walks its mesh's BLAS from the set. Returns (t, BLAS row,
    u, v, inst) or the blocked flags."""
    rays, _ = pack_rays(ro, rd, t_min, t_max)
    nodes = tb.tlas_nodes.cpu().numpy()
    leaf = nodes[:, 7].view(np.int32)
    row_inst = tb.tlas_row_inst.cpu().numpy()
    payload = np.where(leaf >= 0, row_inst[np.maximum(leaf, 0)], -1)
    inv = tb.inst_inv.cpu()
    ranges = torch.stack([tb.inst_node_start, tb.inst_node_count,
                          tb.inst_row_start], dim=1).tolist()
    cache = {}

    def enter(inst):
        key = tuple(ranges[inst])
        if key not in cache:
            cache[key] = _blas_resident(tb, *key)
        return cache[key], inv[inst].tolist(), key[2], inst

    return sweep(tb.tlas_nodes[:, 0:6], nodes[:, 6].view(np.int32), payload,
                 rays, any_hit, enter)


def closest_hit_two_level(tb: TwoLevelBuffers, ro: Vec3, rd: Vec3, t_min=0.0,
                          t_max=T_MAX) -> TwoLevelHit:
    """Nested closest hit (tlas.py:320-334): ``tri`` is the global shading
    row (inst_tri_base + mesh-local tri), -1 on a miss."""
    t, row, u, v, inst = _two_level(tb, ro, rd, t_min, t_max, any_hit=False)
    miss = row < 0
    local = tb.blas_row_tri[torch.clamp(row, min=0).long()]
    base = tb.inst_tri_base[torch.clamp(inst, min=0).long()]
    tri = torch.where(miss, -1, base + local).to(torch.int32)
    return TwoLevelHit(t=t, tri=tri, u=u, v=v, inst=inst)


def occluded_two_level(tb: TwoLevelBuffers, ro: Vec3, rd: Vec3, t_min=0.0,
                       t_max=T_MAX) -> torch.Tensor:
    """Nested any-hit visibility: True where (t_min, t_max) is blocked."""
    return _two_level(tb, ro, rd, t_min, t_max, any_hit=True)
