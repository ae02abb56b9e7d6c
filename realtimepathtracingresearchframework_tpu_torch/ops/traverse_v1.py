"""The v1 walk: the K8a and K8b kernels' wrappers and plain versions.

Counterpart of the reference's ``ops/traverse_pallas.py``, the traversal
that ``RPTR_TRAVERSAL_V1`` selects, over the preorder node array of a
leaf-128 threaded BVH. The triangle table is row-major (Rp, 16) up to
``WIDE_MAX_ROWS`` padded rows (K8a) and field-major (16, Rp) beyond (K8b);
the rays ride a packed (8, Np) operand for K8a and (Np, 8) for K8b, and
the result a (4, Np) or (Np, 4) one (t, row bits, u, v), exactly as the
reference lays them out.

The reference's function is the packet walk (``plain``): a packet of
``BLOCK`` (512) rays shares one cursor, a node is entered when ANY lane's
slab test passes with its far distance capped by the packet's ``cap`` (the
packet max of min(t_best, tmax)), and at a leaf every lane runs
Möller-Trumbore over all 128 rows. K8a and K8b walk each ray on its own
(``plain_lanes``: the port's plain threaded walk
``ops/traverse.py::walk_ranges`` over the v1 tables, K1's function): a lane
tests the leaves its own capped slab test enters, not every leaf its packet
enters. The two agree except on grazing lanes, where a lane hits a triangle
in a leaf whose box its own slab test rejects (a corner, or a 1-ulp gap
between the slab t and Möller-Trumbore's t; a ray along a box face with a
zero direction component enters the box, ``intersect.slab_interval``);
ROADMAP queue 3 records the difference.

On a CPU tensor the wrappers run ``plain_lanes`` in either layout; on a
CUDA tensor they launch ``csrc/traverse_v1.cu`` (built by
``kernels/build.py`` at first use) or raise, never falling back.
``launches_k8a`` and ``launches_k8b`` count the kernel launches,
``merged_launches`` the merged two-queue ones among them.
The reference never coherence-sorts a v1 dispatch, so ``compact`` is
accepted and ignored, as there (traverse_pallas.py:502-538, :600-623).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops.bvh import ThreadedBVH
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import (
    T_MAX,
    safe_inv_dir,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    Hit,
    _mt_rows,
    map_rows_to_tris,
    real_row_counts,
    walk_ranges,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    _check_aligned,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

KERNEL = "traverse_v1"
LEAF = 128  # PALLAS_LEAF_SIZE: rows per leaf
BLOCK = 512  # DEFAULT_BLOCK: rays per packet (one CUDA block)
WIDE_MAX_ROWS = 8192  # the row-major table up to this many padded rows
PLAIN_CHUNK = 32  # packets per leaf batch of the plain version (memory)
launches_k8a = 0  # K8a launches in this process (reset with reset_launches)
launches_k8b = 0  # K8b launches
merged_launches = 0  # of which merged two-queue launches


def reset_launches() -> None:
    global launches_k8a, launches_k8b, merged_launches
    launches_k8a = launches_k8b = merged_launches = 0


class V1BVH(NamedTuple):
    """The v1 walk's tables, all on one device."""

    bounds: torch.Tensor  # (M, 6) f32: node AABB min3, max3
    links: torch.Tensor  # (M, 2) i32: skip link, first leaf ROW (-1 inner)
    tris: torch.Tensor  # (Rp, 16) f32 if ``wide`` else (16, Rp): v0, e1, e2
    row_tri: torch.Tensor  # (Rp,) i32: source triangle of each row
    wide: bool  # row-major table (K8a) or field-major (K8b)
    real_rows: torch.Tensor  # (Rp // 128,) i32: traverse.real_row_counts

    @property
    def num_nodes(self) -> int:
        return self.bounds.shape[0]

    @property
    def num_rows(self) -> int:
        return self.tris.shape[0] if self.wide else self.tris.shape[1]


def pack_v1(tb: ThreadedBVH, device="cpu") -> V1BVH:
    """ThreadedBVH (numpy) -> V1BVH on ``device``: the numpy half of the
    reference's ``pack_for_pallas`` (traverse_pallas.py:67-93). Rows are
    zero-padded to a multiple of 128; links stay int32; each leaf's
    real-row count rides beside them."""
    if tb.leaf_size != LEAF:
        raise ValueError(f"the v1 walk needs leaf_size={LEAF}, got {tb.leaf_size}")
    nodes = np.asarray(tb.nodes, np.float32)
    links = np.stack([nodes[:, 6].view(np.int32), nodes[:, 7].view(np.int32)],
                     axis=1).astype(np.int32)
    r = len(tb.tri_rows)
    rp = r + ((-r) % LEAF)
    wide = rp <= WIDE_MAX_ROWS
    if wide:
        tris = np.zeros((rp, 16), np.float32)
        tris[:r, 0:9] = tb.tri_rows[:, 0:9]
    else:
        tris = np.zeros((16, rp), np.float32)
        tris[0:9, :r] = tb.tri_rows[:, 0:9].T
    row_tri = np.zeros(rp, np.int32)
    row_tri[:r] = tb.row_tri

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    table = torch.from_numpy(tris[:, 0:9] if wide else tris[0:9].T)
    return V1BVH(bounds=dev(nodes[:, 0:6]), links=dev(links), tris=dev(tris),
                 row_tri=dev(row_tri), wide=wide,
                 real_rows=real_row_counts(table, LEAF).to(device))


def prep_rays(ro: Vec3, rd: Vec3, t_min, t_max, wide: bool, block: int = BLOCK):
    """The packed ray operand of ``_prep_rays`` (traverse_pallas.py:467-499):
    rows ro3, rd3, tmin, tmax, padded to a multiple of ``block`` with lanes
    ro 0, rd (1, 0, 0), tmin 0, tmax 0 (they vote in a packet's any-live
    test, so the fill matters), stacked as (8, Np) for K8a or (Np, 8) for
    K8b. Returns (rays, n)."""
    n = ro.x.shape[0]
    dev = ro.x.device

    def full(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev).expand(n)

    cols = [*ro, *rd, full(t_min), full(t_max)]
    pad = (-n) % block
    if pad:
        fills = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0)
        cols = [torch.cat([c, torch.full((pad,), f, dtype=torch.float32, device=dev)])
                for c, f in zip(cols, fills)]
    return torch.stack(cols, dim=0 if wide else 1).contiguous(), n


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _leaf_rows(bvh: V1BVH, row0):
    """(j, 128, 9) rows of the leaves starting at rows ``row0`` (j,)."""
    idx = row0[:, None] + torch.arange(LEAF, device=row0.device)
    if bvh.wide:
        return bvh.tris[idx][..., 0:9]
    return bvh.tris[0:9][:, idx].permute(1, 2, 0)


def plain(bvh: V1BVH, rays, any_hit: bool, shadow_from: int = -1):
    """The packet walk, the reference's K8a and K8b (traverse_pallas.py:
    96-419), in either layout, batched over
    packets: every packet's cursor steps once per iteration until all are
    past the last node. ``rays`` is the packed operand in the kernel's
    layout; packets from ``shadow_from`` on (all of them when ``any_hit``)
    stop once every lane is resolved (a hit, or tmax <= tmin). Returns the
    output in the kernel's layout: t (2e32 on a miss), the row's int32 bits,
    u, v."""
    r8 = rays if bvh.wide else rays.t()
    dev = r8.device
    n_pad = r8.shape[1]
    p = n_pad // BLOCK
    lanes = r8.reshape(8, p, BLOCK)
    ro, rd = lanes[0:3], lanes[3:6]
    tmin, tmax = lanes[6], lanes[7]
    inv = safe_inv_dir(rd)
    iota = torch.arange(LEAF, device=dev)
    m = bvh.num_nodes

    t_best = tmax.clone()
    best_row = torch.full((p, BLOCK), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((p, BLOCK), dtype=torch.float32, device=dev)
    best_v = torch.zeros((p, BLOCK), dtype=torch.float32, device=dev)
    cap = tmax.amax(dim=1)
    cur = torch.zeros(p, dtype=torch.int64, device=dev)
    checks = any_hit or shadow_from >= 0
    early = torch.full((p,), any_hit, dtype=torch.bool, device=dev)
    if shadow_from >= 0:
        early |= torch.arange(p, device=dev) >= shadow_from
    dead = tmax <= tmin

    ids = torch.arange(p, device=dev)
    while ids.numel():
        c = cur[ids]
        box = bvh.bounds[c]
        link = bvh.links[c].to(torch.int64)
        skip, leaf_row = link[:, 0], link[:, 1]
        t0 = [(box[:, a, None] - ro[a][ids]) * inv[a][ids] for a in range(3)]
        t1 = [(box[:, 3 + a, None] - ro[a][ids]) * inv[a][ids] for a in range(3)]
        lo = [torch.minimum(x, y) for x, y in zip(t0, t1)]
        hi = [torch.maximum(x, y) for x, y in zip(t0, t1)]
        tenter = torch.maximum(torch.maximum(lo[0], lo[1]),
                               torch.maximum(lo[2], tmin[ids]))
        texit = torch.minimum(
            torch.minimum(hi[0], hi[1]),
            torch.minimum(hi[2], torch.minimum(tmax[ids], cap[ids, None])))
        any_live = (tenter <= texit).any(dim=1)
        is_leaf = leaf_row >= 0
        do_leaf = any_live & is_leaf
        visit, row0s = ids[do_leaf], leaf_row[do_leaf]
        for s in range(0, visit.numel(), PLAIN_CHUNK):
            pk, row0 = visit[s:s + PLAIN_CHUNK], row0s[s:s + PLAIN_CHUNK]
            rows = _leaf_rows(bvh, row0)[:, :, None, :]  # (j, 128, 1, 9)
            ok, uu, vv, tt = _mt_rows(rows, *(x[pk][:, None, :] for x in (*ro, *rd)))
            tb = t_best[pk]
            lim = torch.minimum(tb, tmax[pk])
            hit = ok & (tt > tmin[pk][:, None, :]) & (tt < lim[:, None, :])
            tt = torch.where(hit, tt, T_MAX)
            t_col = tt.amin(dim=1)
            improved = t_col < tb
            is_best = (tt <= t_col[:, None, :]) & hit
            sub = torch.where(is_best, iota[None, :, None], LEAF).amin(dim=1)
            pick = iota[None, :, None] == sub[:, None, :]
            # the reference's masked sum: a picked -0.0 comes out +0.0
            u_pick = torch.where(pick, uu, 0.0).sum(dim=1)
            v_pick = torch.where(pick, vv, 0.0).sum(dim=1)
            t_best[pk] = torch.where(improved, t_col, tb)
            best_row[pk] = torch.where(
                improved, (row0[:, None] + sub).to(torch.int32), best_row[pk])
            best_u[pk] = torch.where(improved, u_pick, best_u[pk])
            best_v[pk] = torch.where(improved, v_pick, best_v[pk])
        cap[ids] = torch.minimum(t_best[ids], tmax[ids]).amax(dim=1)
        nxt = torch.where(any_live & ~is_leaf, c + 1, skip)
        go = nxt < m
        if checks:
            resolved = ((best_row[ids] >= 0) | dead[ids]).all(dim=1)
            go &= ~(early[ids] & resolved)
        cur[ids] = nxt
        ids = ids[go]

    out = torch.stack([
        torch.where(best_row < 0, T_MAX, t_best).reshape(-1),
        best_row.reshape(-1).view(torch.float32),
        best_u.reshape(-1), best_v.reshape(-1),
    ])
    return out if bvh.wide else out.t().contiguous()


def plain_lanes(bvh: V1BVH, rays, any_hit: bool, shadow_from: int = -1):
    """The function K8a and K8b compute: each lane's own threaded walk of the tree
    (``walk_ranges``, K1's plain version, over the v1 tables: the links'
    leaf ROWS as leaf indices, the table's rows 0-8 as (Rp, 9) rows), in the
    kernel's layout. Lanes from ``shadow_from`` x 512 on (all of them when
    ``any_hit``) stop at their first hit and write row 0 and t = tmax where
    their segment holds a hit, else row -1 and t = 2e32, u = v = 0; the
    others write t (2e32 on a miss), the row's int32 bits, u, v, with -0.0
    written as +0.0 as K8a's masked sum writes it."""
    r8 = rays if bvh.wide else rays.t()
    n = r8.shape[1]
    n_c = 0 if any_hit else min(n, shadow_from * BLOCK) if shadow_from >= 0 else n
    lr = bvh.links[:, 1]
    links = torch.stack([bvh.links[:, 0], torch.where(lr >= 0, lr // LEAF, -1)], 1)
    rows = bvh.tris[:, 0:9] if bvh.wide else bvh.tris[0:9].t()

    def walk(q, mode):
        return walk_ranges(bvh.bounds, links, rows, LEAF, Vec3(*q[0:3]),
                           Vec3(*q[3:6]), q[6], q[7], mode)

    h = walk(r8[:, :n_c], False)
    tmax_s = r8[7, n_c:]
    blocked = walk(r8[:, n_c:], True)
    zeros = torch.zeros_like(tmax_s)
    out = torch.stack([
        torch.cat([h.t, torch.where(blocked, tmax_s, T_MAX)]),
        torch.cat([h.tri, torch.where(blocked, 0, -1).to(torch.int32)]
                  ).view(torch.float32),
        torch.cat([torch.where(h.u == 0.0, 0.0, h.u), zeros]),
        torch.cat([torch.where(h.v == 0.0, 0.0, h.v), zeros]),
    ])
    return out if bvh.wide else out.t().contiguous()


# ---------------------------------------------------------------------------
# The kernel launch
# ---------------------------------------------------------------------------


def _lib():
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    lib = build.load(KERNEL)
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rptr_traverse_v1.argtypes = [p, p, p, p, i, i, p, i, i, i, p, p, i, i]
    lib.rptr_traverse_v1.restype = ctypes.c_int
    lib.rptr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rptr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def bind(bvh: V1BVH, rays, any_hit: bool, shadow_from: int = -1,
         threads: int = None, scan_from: int = None):
    """Check the operands of one K8a (row-major table) or K8b (field-major)
    launch over the packed operand ``rays`` in its layout, allocate its
    output and bind it. ``threads`` (a multiple of 32 dividing 512) and
    ``scan_from`` (a leaf that this many lanes of a warp hold is scanned by
    each of them alone; > 32 never) force the block size and the leaf
    service, else the kernel's defaults; neither changes the result.
    Returns (run, out): ``run()`` launches the kernel on the current device,
    uncounted, and returns its CUDA error code (0 = launched); None when
    there is no lane."""
    dev = rays.device
    m, rp = bvh.num_nodes, bvh.num_rows
    n_pad = rays.shape[1] if bvh.wide else rays.shape[0]
    if n_pad % BLOCK:
        raise ValueError(f"{KERNEL}: {n_pad} lanes are not whole packets of {BLOCK}")
    _check("bounds", bvh.bounds, torch.float32, (m, 6), dev)
    _check("links", bvh.links, torch.int32, (m, 2), dev)
    _check("tris", bvh.tris, torch.float32, (rp, 16) if bvh.wide else (16, rp), dev)
    _check("real_rows", bvh.real_rows, torch.int32, (rp // LEAF,), dev)
    _check("rays", rays, torch.float32, (8, n_pad) if bvh.wide else (n_pad, 8), dev)
    out = torch.empty((4, n_pad) if bvh.wide else (n_pad, 4), dtype=torch.float32,
                      device=dev)
    if n_pad == 0:
        return None, out
    # 8-byte node and link loads, 16-byte table loads; K8b's 16-byte ray
    # loads and output stores
    aligned = [("bounds", bvh.bounds, 8), ("links", bvh.links, 8),
               ("tris", bvh.tris, 16)]
    if not bvh.wide:
        aligned += [("rays", rays, 16), ("out", out, 16)]
    for name, x, nbytes in aligned:
        _check_aligned(name, x, nbytes)
    packets = n_pad // BLOCK
    # packets from early_from on take the any-hit mode
    early_from = 0 if any_hit else (shadow_from if shadow_from >= 0 else packets)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    args = (bvh.bounds.data_ptr(), bvh.links.data_ptr(), bvh.real_rows.data_ptr(),
            bvh.tris.data_ptr(), rp, m, rays.data_ptr(), n_pad, early_from,
            int(bvh.wide), out.data_ptr(), stream, threads or 0,
            -1 if scan_from is None else scan_from)

    def run():
        return lib.rptr_traverse_v1(*args)

    return run, out


def launch(bvh: V1BVH, rays, any_hit: bool, shadow_from: int = -1,
           threads: int = None, scan_from: int = None):
    """One K8a (row-major table) or K8b (field-major) launch over the packed
    operand ``rays`` in its layout (``bind``'s arguments), counted, as
    ``plain_lanes`` computes it. Returns the output in the same layout."""
    global launches_k8a, launches_k8b
    run, out = bind(bvh, rays, any_hit, shadow_from, threads, scan_from)
    if run is None:
        return out
    with torch.cuda.device(rays.device):
        rc = run()
    if rc != 0:
        msg = _lib().rptr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{KERNEL} launch failed: {msg} (cudaError {rc})")
    if bvh.wide:
        launches_k8a += 1
    else:
        launches_k8b += 1
    return out


def _run(bvh: V1BVH, rays, any_hit: bool, shadow_from: int = -1):
    if rays.device.type == "cpu":
        return plain_lanes(bvh, rays, any_hit, shadow_from)
    if rays.device.type == "cuda":
        return launch(bvh, rays, any_hit, shadow_from)
    raise ValueError(f"no traversal for device {rays.device}")


def _fields(bvh: V1BVH, out, lo: int, hi: int):
    """(t, row, u, v) of lanes [lo, hi) of an output."""
    f = out[:, lo:hi] if bvh.wide else out[lo:hi].t()
    return f[0], f[1].contiguous().view(torch.int32), f[2], f[3]


def _hit(bvh: V1BVH, t, row, u, v, map_tri: bool) -> Hit:
    hit = Hit(t=t, tri=row, u=u, v=v)
    return map_rows_to_tris(bvh, hit) if map_tri else hit


def closest_hit_v1(bvh: V1BVH, ro: Vec3, rd: Vec3, t_min=0.0, t_max=T_MAX,
                   map_tri: bool = True, compact: bool = False) -> Hit:
    """Closest hit per ray (traverse_pallas.closest_hit_pallas). ``map_tri``
    False returns the BVH row, the attribute index of row-ordered tables.
    ``compact`` is ignored, as the reference ignores it."""
    rays, n = prep_rays(ro, rd, t_min, t_max, bvh.wide)
    return _hit(bvh, *_fields(bvh, _run(bvh, rays, False), 0, n), map_tri)


def occluded_v1(bvh: V1BVH, ro: Vec3, rd: Vec3, t_min=0.0, t_max=T_MAX,
                compact: bool = False) -> torch.Tensor:
    """Any-hit visibility (traverse_pallas.occluded_pallas): True where the
    segment holds a hit. ``compact`` is ignored."""
    rays, n = prep_rays(ro, rd, t_min, t_max, bvh.wide)
    return _fields(bvh, _run(bvh, rays, True), 0, n)[1] >= 0


def closest_and_occluded_v1(bvh: V1BVH, comps_c, tmin_c, tmax_c, comps_s,
                            tmin_s, tmax_s, map_tri: bool = True,
                            compact: bool = False):
    """The wavefront's closest queue and its deferred shadow queue in ONE
    launch (traverse_pallas.closest_and_occluded_pallas): each queue padded
    to whole packets, the shadow packets after the closest ones, taking the
    any-hit exit. ``comps_*`` are (ox, oy, oz, dx, dy, dz). Returns (Hit of
    the closest queue, blocked flags of the shadow queue)."""
    global merged_launches
    rays_c, n = prep_rays(Vec3(*comps_c[0:3]), Vec3(*comps_c[3:6]), tmin_c,
                          tmax_c, bvh.wide)
    rays_s, n2 = prep_rays(Vec3(*comps_s[0:3]), Vec3(*comps_s[3:6]), tmin_s,
                           tmax_s, bvh.wide)
    axis = 1 if bvh.wide else 0
    np_c = rays_c.shape[axis]
    out = _run(bvh, torch.cat([rays_c, rays_s], dim=axis), False, np_c // BLOCK)
    if out.device.type == "cuda":
        merged_launches += 1
    blocked = _fields(bvh, out, np_c, np_c + n2)[1] >= 0
    return _hit(bvh, *_fields(bvh, out, 0, n), map_tri), blocked
