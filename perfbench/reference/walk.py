"""The reference's own BVH and its closest-hit and any-hit walks.

Independent of the program's packs and kernels: the triangles are sorted by
the Morton code of their centroids, cut into leaves of ``LEAF`` triangles,
and a complete binary tree over the leaves is laid out as a heap (node i
has children 2i+1 and 2i+2), its boxes reduced level by level. The walk is
the stackless threaded one: enter a node whose box the ray's segment,
capped by its best hit so far, crosses; otherwise jump to the next subtree
in preorder. The leaf test is Moller-Trumbore in the expression order of
the program's plain walks, so a hit on the same triangle has the same t,
u and v; two triangles hit at exactly the same t may resolve to either.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.intersect import T_MAX, ray_aabb, safe_inv_dir
from perfbench.reference.vec3 import Vec3

LEAF = 8


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    lo = centroids.min(axis=0)
    ext = np.maximum(centroids.max(axis=0) - lo, 1e-20)
    q = np.clip(((centroids - lo) / ext * 1023.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def _mt_rows(rows, rox, roy, roz, rdx, rdy, rdz):
    """Moller-Trumbore of k rays against their (k, LEAF) rows. Returns
    (ok, u, v, t); ``ok`` is the determinant and barycentric part."""
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


class Walk:
    """A BVH over (v0, e1, e2) triangles (numpy (T, 3) f32) on ``device``;
    hits report source triangle ids."""

    def __init__(self, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, device):
        n = len(v0)
        order = _morton_order(v0 + (e1 + e2) * np.float32(1.0 / 3.0))
        n_leaves = max(1, -(-n // LEAF))
        n_leaf_pad = 1 << max(0, (n_leaves - 1).bit_length())
        rows = np.zeros((n_leaf_pad * LEAF, 9), np.float32)  # zero rows never hit
        tri = np.full(n_leaf_pad * LEAF, -1, np.int32)
        rows[:n] = np.concatenate([v0, e1, e2], axis=1)[order]
        tri[:n] = order
        p0 = rows[:, 0:3]
        p1 = p0 + rows[:, 3:6]
        p2 = p0 + rows[:, 6:9]
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        real = (tri >= 0)[:, None]
        lo = np.where(real, lo, np.nan).reshape(n_leaf_pad, LEAF, 3)
        hi = np.where(real, hi, np.nan).reshape(n_leaf_pad, LEAF, 3)
        # an empty box is NaN, which every slab test misses; fmin and fmax
        # keep it out of its parents
        lo, hi = np.fmin.reduce(lo, axis=1), np.fmax.reduce(hi, axis=1)
        # heap layout: the leaves are the last n_leaf_pad nodes
        m = 2 * n_leaf_pad - 1
        bounds = np.empty((m, 6), np.float32)
        bounds[n_leaf_pad - 1:, 0:3] = lo
        bounds[n_leaf_pad - 1:, 3:6] = hi
        first = n_leaf_pad - 1
        while first > 0:
            parent0 = (first - 1) // 2
            kids = bounds[first:2 * first + 1]
            bounds[parent0:first, 0:3] = np.fmin(kids[0::2, 0:3], kids[1::2, 0:3])
            bounds[parent0:first, 3:6] = np.fmax(kids[0::2, 3:6], kids[1::2, 3:6])
            first = parent0
        skip = np.empty(m, np.int64)
        skip[0] = m  # past the last node
        for i in range(1, m):
            skip[i] = i + 1 if i % 2 == 1 else skip[(i - 1) // 2]
        self.first_leaf = n_leaf_pad - 1
        self.num_nodes = m
        self.bounds = torch.from_numpy(bounds).to(device)
        self.skip = torch.from_numpy(skip).to(device)
        self.rows = torch.from_numpy(rows).to(device)
        self.tri = torch.from_numpy(tri).to(device)
        self.device = device
        self.steps = 0  # walk iterations, for the reference's own cost

    def _walk(self, ro: Vec3, rd: Vec3, t_min, t_max, any_hit: bool):
        n = ro.x.shape[0]
        dev = self.device
        tmin = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
        tmax = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
        ro3 = torch.stack([ro.x, ro.y, ro.z], dim=-1)
        rd3 = torch.stack([rd.x, rd.y, rd.z], dim=-1)
        inv3, zero3 = safe_inv_dir(rd3), rd3 == 0.0
        sub_iota = torch.arange(LEAF, device=dev)
        t_best = tmax.clone()
        best_row = torch.full((n,), -1, dtype=torch.int64, device=dev)
        best_u = torch.zeros(n, dtype=torch.float32, device=dev)
        best_v = torch.zeros(n, dtype=torch.float32, device=dev)
        blocked = torch.zeros(n, dtype=torch.bool, device=dev)
        cur = torch.zeros(n, dtype=torch.int64, device=dev)
        end = self.num_nodes
        ids = torch.nonzero(tmax > tmin).squeeze(1)
        while ids.numel():
            self.steps += 1
            node = cur[ids]
            box = self.bounds[node]
            hit_box, _ = ray_aabb(ro3[ids], inv3[ids], box[:, 0:3], box[:, 3:6],
                                  tmin[ids], t_best[ids], zero3[ids])
            is_leaf = node >= self.first_leaf
            visit = hit_box & is_leaf
            vi = ids[visit]
            if vi.numel():
                row0 = (node[visit] - self.first_leaf) * LEAF
                rows = self.rows[row0[:, None] + sub_iota]
                ok, uu, vv, tt = _mt_rows(
                    rows, ro.x[vi, None], ro.y[vi, None], ro.z[vi, None],
                    rd.x[vi, None], rd.y[vi, None], rd.z[vi, None])
                lim = torch.minimum(t_best[vi], tmax[vi])
                hit = ok & (tt > tmin[vi, None]) & (tt < lim[:, None])
                found = hit.any(dim=1)
                if any_hit:
                    blocked[vi] = found
                else:
                    tt = torch.where(hit, tt, T_MAX)
                    t_leaf = tt.amin(dim=1)
                    sub = torch.where(hit & (tt <= t_leaf[:, None]), sub_iota,
                                      LEAF).amin(dim=1)
                    pick = torch.clamp(sub, max=LEAF - 1)[:, None]
                    t_best[vi] = torch.where(found, t_leaf, t_best[vi])
                    best_row[vi] = torch.where(found, row0 + sub, best_row[vi])
                    best_u[vi] = torch.where(found, uu.gather(1, pick)[:, 0],
                                             best_u[vi])
                    best_v[vi] = torch.where(found, vv.gather(1, pick)[:, 0],
                                             best_v[vi])
            nxt = torch.where(hit_box & ~is_leaf, 2 * node + 1, self.skip[node])
            if any_hit:
                nxt = torch.where(blocked[ids], end, nxt)
            cur[ids] = nxt
            ids = ids[nxt < end]
        if any_hit:
            return blocked
        miss = best_row < 0
        tri = torch.where(miss, -1, self.tri[torch.clamp(best_row, min=0)])
        return torch.where(miss, T_MAX, t_best), tri, best_u, best_v

    def closest(self, ro: Vec3, rd: Vec3, t_min, t_max):
        """(t, tri, u, v) of each ray's closest hit in (t_min, t_max);
        tri -1 and t T_MAX on a miss."""
        return self._walk(ro, rd, t_min, t_max, any_hit=False)

    def occluded(self, ro: Vec3, rd: Vec3, t_min, t_max) -> torch.Tensor:
        """True where (t_min, t_max) holds a hit."""
        return self._walk(ro, rd, t_min, t_max, any_hit=True)
