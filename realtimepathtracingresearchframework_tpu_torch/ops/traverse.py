"""BVH traversal, plain PyTorch version of the resident-walk kernel (K1).

Port of the reference's stackless threaded walk
(``ops/traverse.py::closest_hit_threaded`` / ``occluded_threaded``,
traverse.py:91-156,300-321) over the resident layout that the CUDA kernel
reads (``ResidentBVH``, packed by ``traverse_resident.pack_resident``).
This is the function the kernel must equal: per ray, walk the preorder
node array from node 0; enter a node when the slab test passes with the
far distance capped by the ray's best hit so far, else jump to its skip
link; at a leaf, run Möller-Trumbore over its ``leaf_size`` rows in the
expression order of ``traverse_pallas2._mt_leaf`` (:264-310).

Vectorised over rays: every live ray steps its own cursor once per
iteration, and the loop ends when every cursor has passed the last node
(or, for occlusion, found a blocker). On CPU tensors this is what the
renderer runs; on CUDA tensors only the tests and ``chip_smoke.py`` call
it, to check the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realtimepathtracingresearchframework_tpu_torch.ops.intersect import (
    T_MAX,
    ray_aabb,
    safe_inv_dir,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3


class ResidentBVH(NamedTuple):
    """Threaded BVH as the resident kernel reads it (all on one device)."""

    bounds: torch.Tensor  # (M, 6) f32: node AABB min3, max3
    links: torch.Tensor  # (M, 2) i32: skip link, leaf index (-1 = internal)
    tri_rows: torch.Tensor  # (R, 9) f32: v0, e1, e2 per row, leaf-major
    row_tri: torch.Tensor  # (R,) i32: source triangle of each row
    leaf_size: int  # rows per leaf; leaf k owns rows [k*ls, (k+1)*ls)
    real_rows: torch.Tensor  # (R // ls,) i32: each leaf's real_row_counts

    @property
    def num_nodes(self) -> int:
        return self.bounds.shape[0]


def real_row_counts(tri_rows: torch.Tensor, ls: int) -> torch.Tensor:
    """(R // ls,) int32: each leaf's real-row count, the least c such that
    rows [c, ls) of the leaf all equal row c - 1 bit for bit (the packs pad
    a leaf by repeating its last triangle). Such a row can never change a
    walk's result: the earlier equal row was tested first under a cap at
    least as large (a scan), wins the (t, k) tie (a warp's reduction) or
    has already ended the walk (any-hit). So a kernel may stop a leaf at
    its count, and its result stays its plain version's bit for bit. From
    the rows' bits (fields 0-8), not from ``row_tri``, so the skip is exact
    by construction."""
    bits = tri_rows[:, 0:9].contiguous().view(torch.int32).reshape(-1, ls, 9)
    if ls == 1:
        return torch.ones(bits.shape[0], dtype=torch.int32, device=bits.device)
    new = (bits[:, 1:] != bits[:, :-1]).any(dim=-1)  # row k differs from k - 1
    k = torch.arange(1, ls, device=bits.device)
    return (torch.where(new, k, 0).amax(dim=1) + 1).to(torch.int32)


class Hit(NamedTuple):
    t: torch.Tensor  # T_MAX on miss
    tri: torch.Tensor  # i32, -1 on miss (a BVH row unless mapped to tris)
    u: torch.Tensor
    v: torch.Tensor

    @property
    def valid(self):
        return self.tri >= 0


def _mt_rows(rows, rox, roy, roz, rdx, rdy, rdz):
    """Möller-Trumbore of k rays against their (k, ls) rows, in the
    expression order of ``traverse_pallas2._mt_leaf``. Returns (ok, u, v,
    t) where ``ok`` is the determinant and barycentric part of the test."""
    v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det.abs() > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, 0.0)
    tvx = rox - v0x
    tvy = roy - v0y
    tvz = roz - v0z
    uu = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vv = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
    return ok, uu, vv, tt


def walk_ranges(bounds, links, tri_rows, ls: int, ro: Vec3, rd: Vec3, t_min,
                t_max, any_hit: bool, node0=0, count=None, row0=0):
    """The plain threaded walk, each ray over its own tree of a
    concatenation: ray i walks nodes ``node0[i] + c`` for its cursor c from
    0 until c reaches ``count[i]``, with tree-local skip links and leaf ids
    (``links``), and leaf l of its tree owns the rows ``row0[i] + l * ls``
    of ``tri_rows``. ``node0``, ``count`` and ``row0`` are (N,) int64
    tensors or ints (``count`` defaults to every node). Returns the Hit
    with rows ``row0 + l * ls + k``, or the blocked flags."""
    n = ro.x.shape[0]
    dev = ro.x.device
    m = bounds.shape[0] if count is None else count
    tmin = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    tmax = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    ro3 = torch.stack([ro.x, ro.y, ro.z], dim=-1)
    rd3 = torch.stack([rd.x, rd.y, rd.z], dim=-1)
    inv3, zero3 = safe_inv_dir(rd3), rd3 == 0.0
    sub_iota = torch.arange(ls, device=dev)

    def per_ray(x, ids):
        return x[ids] if isinstance(x, torch.Tensor) else x

    t_best = tmax.clone()
    best_row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)

    # an empty segment (tmax <= tmin) can never hit: it walks nothing
    ids = torch.nonzero(tmax > tmin).squeeze(1)
    while ids.numel():
        c = cur[ids]
        node = c + per_ray(node0, ids)
        box = bounds[node]
        hit_box, _ = ray_aabb(
            ro3[ids], inv3[ids], box[:, 0:3], box[:, 3:6], tmin[ids], t_best[ids],
            zero3[ids],
        )
        link = links[node].to(torch.int64)
        skip, leaf = link[:, 0], link[:, 1]
        is_leaf = leaf >= 0
        visit = hit_box & is_leaf
        vi = ids[visit]
        if vi.numel():
            row0_v = leaf[visit] * ls + per_ray(row0, vi)
            rows = tri_rows[row0_v[:, None] + sub_iota]  # (k, ls, 9)
            ok, uu, vv, tt = _mt_rows(
                rows,
                ro.x[vi, None], ro.y[vi, None], ro.z[vi, None],
                rd.x[vi, None], rd.y[vi, None], rd.z[vi, None],
            )
            lim = torch.minimum(t_best[vi], tmax[vi])
            hit = ok & (tt > tmin[vi, None]) & (tt < lim[:, None])
            found = hit.any(dim=1)
            if any_hit:
                blocked[vi] = found
            else:
                # closest hit in the leaf; an exact-t tie goes to the lower
                # row. Every hit beats t_best strictly, so any hit improves.
                tt = torch.where(hit, tt, T_MAX)
                t_leaf = tt.amin(dim=1)
                sub = torch.where(
                    hit & (tt <= t_leaf[:, None]), sub_iota, ls
                ).amin(dim=1)
                pick = torch.clamp(sub, max=ls - 1)[:, None]
                t_best[vi] = torch.where(found, t_leaf, t_best[vi])
                best_row[vi] = torch.where(
                    found, (row0_v + sub).to(torch.int32), best_row[vi]
                )
                best_u[vi] = torch.where(
                    found, uu.gather(1, pick)[:, 0], best_u[vi]
                )
                best_v[vi] = torch.where(
                    found, vv.gather(1, pick)[:, 0], best_v[vi]
                )
        nxt = torch.where(hit_box & ~is_leaf, c + 1, skip)
        end = per_ray(m, ids)
        if any_hit:
            nxt = torch.where(blocked[ids], end, nxt)
        cur[ids] = nxt
        ids = ids[nxt < end]
    if any_hit:
        return blocked
    miss = best_row < 0
    return Hit(
        t=torch.where(miss, T_MAX, t_best), tri=best_row, u=best_u, v=best_v
    )


def map_rows_to_tris(bvh: ResidentBVH, hit: Hit) -> Hit:
    """Row-space hit -> source-triangle hit (-1 stays -1)."""
    row = hit.tri.to(torch.int64)
    tri = torch.where(
        row < 0, -1, bvh.row_tri[torch.clamp(row, min=0)].to(torch.int64)
    )
    return hit._replace(tri=tri.to(torch.int32))


def closest_hit_threaded(bvh: ResidentBVH, ro: Vec3, rd: Vec3, t_min=0.0,
                         t_max=T_MAX) -> Hit:
    """Closest hit of each ray: ``Hit`` of (N,) tensors with ``tri`` the
    BVH row (see ``map_rows_to_tris``)."""
    return walk_ranges(bvh.bounds, bvh.links, bvh.tri_rows, bvh.leaf_size,
                       ro, rd, t_min, t_max, any_hit=False)


def occluded_threaded(bvh: ResidentBVH, ro: Vec3, rd: Vec3, t_min=0.0,
                      t_max=T_MAX) -> torch.Tensor:
    """Any-hit visibility: True where (t_min, t_max) holds a hit."""
    return walk_ranges(bvh.bounds, bvh.links, bvh.tri_rows, bvh.leaf_size,
                       ro, rd, t_min, t_max, any_hit=True)
