"""Resident threaded-BVH traversal: the K1 kernel's wrapper.

Counterpart of the reference's ``ops/traverse_pallas2.py``: the BVH lives
on the device as one node table and one triangle-row table, and every ray
walks it to its closest hit (``closest_hit_resident``) or to its first
blocker (``occluded_resident``), or both queues of a wavefront bounce go in
one launch, the closest queue in the first blocks and the shadow queue
after it (``closest_and_occluded_resident``, the merged mode).

On a CPU tensor the wrapper runs the plain PyTorch version
(``ops/traverse.py``). On a CUDA tensor it launches the hand-written
kernel ``csrc/traverse_resident.cu`` (built by ``kernels/build.py`` at
first use) or raises; it never falls back to the plain version there.
The kernel runs tlas_walk.cuh's per-lane walk with warp-served leaves, each
stopped at its real-row count (``ResidentBVH.real_rows``), at leaf sizes
32, 64 and 128. ``launches`` counts kernel launches, so a run can show that
it went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops.bvh import ThreadedBVH
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    Hit,
    ResidentBVH,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

KERNEL = "traverse_resident"
BLOCK = 128  # rays per CUDA block (kBlock of csrc/traverse_resident.cu)
LEAF_SIZES = (32, 64, 128)
launches = 0  # K1 launches in this process (reset with reset_launches)
merged_launches = 0  # of which merged two-queue launches


def reset_launches() -> None:
    global launches, merged_launches
    launches = merged_launches = 0


def pack_resident(tb: ThreadedBVH, device="cpu") -> ResidentBVH:
    """ThreadedBVH (numpy) -> ResidentBVH on ``device``. The numpy half of
    the reference's ``pack_for_pallas2`` (traverse_pallas2.py:88-119):
    node links become the skip index and the LEAF index (row // leaf_size),
    kept as int32 — never as float values or bit patterns — and each
    leaf's real-row count (``traverse.real_row_counts``)."""
    ls = int(tb.leaf_size)
    nodes = np.asarray(tb.nodes, np.float32)
    skip = nodes[:, 6].view(np.int32)
    leaf_row = nodes[:, 7].view(np.int32)
    rows = np.ascontiguousarray(tb.tri_rows[:, 0:9], np.float32)
    if rows.shape[0] % ls or np.any(leaf_row[leaf_row >= 0] % ls):
        raise ValueError(f"tri rows are not {ls}-row leaves")
    links = np.stack(
        [skip, np.where(leaf_row >= 0, leaf_row // ls, -1)], axis=1
    ).astype(np.int32)
    return ResidentBVH(
        bounds=torch.from_numpy(np.ascontiguousarray(nodes[:, 0:6])).to(device),
        links=torch.from_numpy(links).to(device),
        tri_rows=torch.from_numpy(rows).to(device),
        row_tri=torch.from_numpy(np.asarray(tb.row_tri, np.int32)).to(device),
        leaf_size=ls,
        real_rows=traverse.real_row_counts(torch.from_numpy(rows), ls).to(device),
    )


def _lib():
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    lib = build.load(KERNEL)
    # every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit C int and cut the pointer
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rptr_traverse_resident.argtypes = (
        [p, p, p, p, i, i] + [p] * 8 + [i, i] + [p] * 5 + [p, i]
    )
    lib.rptr_traverse_resident.restype = ctypes.c_int
    lib.rptr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rptr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_aligned(name, x, nbytes: int):
    """A kernel reads ``x`` in loads of ``nbytes`` bytes."""
    if x.data_ptr() % nbytes:
        raise ValueError(f"{name}: its data must be {nbytes}-byte aligned")


def bind(bvh: ResidentBVH, comps, tmin, tmax, shadow_from: int,
         scan_from: int = None):
    """Check the operands of one K1 launch over n rays in blocks of BLOCK
    (blocks before ``shadow_from`` run the closest mode, the rest the
    any-hit mode), allocate its outputs and bind it. ``scan_from`` (a leaf
    that this many lanes of a warp hold is scanned by each of them alone;
    > 32 never; default 16, csrc/traverse_resident.cu) forces the leaf
    service; it does not change the result. Returns (run, (t, row, u, v) of
    the closest lanes, blocked flags of the any-hit lanes): ``run()``
    launches the kernel on the current device, uncounted, and returns its
    CUDA error code (0 = launched); None when there is no lane."""
    dev = comps[0].device
    n = comps[0].shape[0]
    m = bvh.num_nodes
    r, ls = bvh.tri_rows.shape[0], bvh.leaf_size
    if ls not in LEAF_SIZES:
        raise ValueError(f"{KERNEL}: leaf size {ls} not in {LEAF_SIZES}")
    _check("bounds", bvh.bounds, torch.float32, (m, 6), dev)
    _check("links", bvh.links, torch.int32, (m, 2), dev)
    _check("tri_rows", bvh.tri_rows, torch.float32, (r, 9), dev)
    _check("real_rows", bvh.real_rows, torch.int32, (r // ls,), dev)
    # 8-byte node and link loads; a lane reads its ls / 32 rows in loads of
    # 4 * ls / 32 bytes
    for name, x, nbytes in (("bounds", bvh.bounds, 8), ("links", bvh.links, 8),
                            ("tri_rows", bvh.tri_rows, 4 * ls // 32)):
        _check_aligned(name, x, nbytes)
    for k, x in zip(("ox", "oy", "oz", "dx", "dy", "dz", "tmin", "tmax"),
                    (*comps, tmin, tmax)):
        _check(k, x, torch.float32, (n,), dev)
    n_c = min(shadow_from * BLOCK, n)
    if n_c < n and n_c % BLOCK:
        raise ValueError(f"{KERNEL}: the closest half ({n_c} lanes) is not "
                         f"whole blocks of {BLOCK}")
    closest = (torch.empty(n_c, dtype=torch.float32, device=dev),
               torch.empty(n_c, dtype=torch.int32, device=dev),
               torch.empty(n_c, dtype=torch.float32, device=dev),
               torch.empty(n_c, dtype=torch.float32, device=dev))
    blocked = torch.empty(n - n_c, dtype=torch.bool, device=dev)
    if n == 0:
        return None, closest, blocked
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    args = (bvh.bounds.data_ptr(), bvh.links.data_ptr(), bvh.real_rows.data_ptr(),
            bvh.tri_rows.data_ptr(), m, ls,
            *(x.data_ptr() for x in comps), tmin.data_ptr(), tmax.data_ptr(),
            n, shadow_from, *(x.data_ptr() or None for x in (*closest, blocked)),
            stream, -1 if scan_from is None else scan_from)

    def run():
        return lib.rptr_traverse_resident(*args)

    return run, closest, blocked


def _launch(bvh: ResidentBVH, comps, tmin, tmax, shadow_from: int,
            scan_from: int = None):
    """One K1 launch (``bind``'s arguments), counted. Returns ((t, row, u, v)
    of the closest lanes, blocked flags of the any-hit lanes); either may
    have no lanes."""
    global launches
    run, closest, blocked = bind(bvh, comps, tmin, tmax, shadow_from, scan_from)
    if run is None:
        return closest, blocked
    with torch.cuda.device(comps[0].device):
        rc = run()
    if rc != 0:
        msg = _lib().rptr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{KERNEL} launch failed: {msg} (cudaError {rc})")
    launches += 1
    return closest, blocked


def _ray_operands(ro: Vec3, rd: Vec3, t_min, t_max):
    n = ro.x.shape[0]
    dev = ro.x.device

    def full(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev).expand(n)

    comps = tuple(c.contiguous() for c in (*ro, *rd))
    return comps, full(t_min).contiguous(), full(t_max).contiguous()


# ---------------------------------------------------------------------------
# Packed ray operand and the coherence sort (traverse_pallas.py::_prep_rays,
# traverse_pallas2.py:587-676). u32 keys ride int64 tensors: CPU torch has no
# uint32 add, shift or compare. The permutation is a plain index; the
# reference's int32 bitcast carrier in _uncompact exists for TPU denormal
# flushing, and a torch gather of floats is bitwise.
# ---------------------------------------------------------------------------


def pack_rays(ro: Vec3, rd: Vec3, t_min, t_max, block: int = 1):
    """(8, Np) f32 rows [ro3, rd3, tmin, tmax], padded to a multiple of
    ``block`` with dead lanes (ro 0, rd +x, tmin = tmax = 0). Returns
    (rays, n)."""
    comps, tmin, tmax = _ray_operands(ro, rd, t_min, t_max)
    n = comps[0].shape[0]
    rays = torch.stack([*comps, tmin, tmax])
    pad = (-n) % block
    if pad:
        fill = torch.zeros((8, pad), dtype=torch.float32, device=rays.device)
        fill[3] = 1.0
        rays = torch.cat([rays, fill], dim=1)
    return rays, n


def _part1by2(x):
    """Spread the low 10 bits of x two apart (morton dilation)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def coherence_key(ox, oy, oz, dx, dy, dz, live, lo, hi):
    """u32 lane sort key (as int64): bit 31 = dead lane (sorts last), bits
    21-23 = direction octant, bits 0-20 = origin morton on a 128^3 grid
    over the scene box [lo, hi] (traverse_pallas2._coherence_key2 and
    integrator._carry_coherence_key). ``lo is None`` keys on liveness
    alone."""
    dead = (~live).to(torch.int64) << 31
    if lo is None:
        return dead
    inv = 127.0 / torch.clamp(hi - lo, min=1e-12)

    def q(v, k):
        return torch.clamp((v - lo[k]) * inv[k], 0.0, 127.0).to(torch.int64)

    morton = (
        _part1by2(q(ox, 0))
        | (_part1by2(q(oy, 1)) << 1)
        | (_part1by2(q(oz, 2)) << 2)
    )
    octant = (
        ((dx < 0.0).to(torch.int64) << 2)
        | ((dy < 0.0).to(torch.int64) << 1)
        | (dz < 0.0).to(torch.int64)
    )
    return dead | (octant << 21) | morton


def _coherence_key2(rays, scene_lo, scene_hi):
    """Key of a packed (8, Np) operand (traverse_pallas2.py:597-624)."""
    return coherence_key(*rays[0:6], rays[7] > rays[6], scene_lo, scene_hi)


def inverse_permutation(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return inv


def _compact(rays, scene_lo=None, scene_hi=None):
    """Stable live-first, coherence-ordered lane sort of a packed (8, Np)
    operand (traverse_pallas2.py:627-660). Returns (rays_sorted, inv):
    ``out[..., inv]`` restores the original lane order."""
    key = _coherence_key2(rays, scene_lo, scene_hi)
    perm = torch.argsort(key, stable=True)
    return rays[:, perm], inverse_permutation(perm)


def _uncompact(out, inv):
    """Sorted-order result -> original lane order (out_orig[..., i] =
    out[..., inv[i]])."""
    return out[..., inv]


def _sorted_rays(bvh, ro, rd, t_min, t_max):
    """The coherence-sorted operand of a K1 dispatch, scene box = root
    node (traverse_pallas2.closest_hit_pallas2's ``compact``)."""
    rays, n = pack_rays(ro, rd, t_min, t_max)
    rays, inv = _compact(rays, bvh.bounds[0, 0:3], bvh.bounds[0, 3:6])
    return Vec3(*rays[0:3]), Vec3(*rays[3:6]), rays[6], rays[7], inv


def closest_hit_resident(bvh: ResidentBVH, ro: Vec3, rd: Vec3, t_min=0.0,
                         t_max=T_MAX, compact: bool = False) -> Hit:
    """Closest hit per ray. ``tri`` is the BVH row, the attribute index of
    row-ordered tables (``traverse.map_rows_to_tris`` maps it to the
    source triangle). ``compact`` coherence-sorts the lanes first; the
    result is the same, in the caller's lane order."""
    if compact:
        o, d, tmin, tmax, inv = _sorted_rays(bvh, ro, rd, t_min, t_max)
        hit = closest_hit_resident(bvh, o, d, tmin, tmax)
        return Hit(*(_uncompact(x, inv) for x in hit))
    if ro.x.device.type == "cpu":
        return traverse.closest_hit_threaded(bvh, ro, rd, t_min, t_max)
    if ro.x.device.type == "cuda":
        comps, tmin, tmax = _ray_operands(ro, rd, t_min, t_max)
        t, row, u, v = _launch(bvh, comps, tmin, tmax,
                               -(-comps[0].shape[0] // BLOCK))[0]
        return Hit(t=t, tri=row, u=u, v=v)
    raise ValueError(f"no traversal for device {ro.x.device}")


def occluded_resident(bvh: ResidentBVH, ro: Vec3, rd: Vec3, t_min=0.0,
                      t_max=T_MAX, compact: bool = False) -> torch.Tensor:
    """Any-hit visibility per ray: True where (t_min, t_max) is blocked."""
    if compact:
        o, d, tmin, tmax, inv = _sorted_rays(bvh, ro, rd, t_min, t_max)
        return _uncompact(occluded_resident(bvh, o, d, tmin, tmax), inv)
    if ro.x.device.type == "cpu":
        return traverse.occluded_threaded(bvh, ro, rd, t_min, t_max)
    if ro.x.device.type == "cuda":
        comps, tmin, tmax = _ray_operands(ro, rd, t_min, t_max)
        return _launch(bvh, comps, tmin, tmax, 0)[1]
    raise ValueError(f"no traversal for device {ro.x.device}")


# ---------------------------------------------------------------------------
# Merged mode: the wavefront's two per-bounce queues in one launch
# (traverse_pallas2.closest_and_occluded_pallas2, :736)
# ---------------------------------------------------------------------------


def merged_plain(bvh: ResidentBVH, rays, n_closest: int):
    """The plain version of a merged launch over a packed (8, N) operand:
    the plain closest walk on lanes [0, n_closest), the plain occluded walk
    on the rest. Returns ((t, row, u, v), blocked)."""
    c, s = rays[:, :n_closest], rays[:, n_closest:]
    hit = traverse.closest_hit_threaded(bvh, Vec3(*c[0:3]), Vec3(*c[3:6]), c[6], c[7])
    blocked = traverse.occluded_threaded(bvh, Vec3(*s[0:3]), Vec3(*s[3:6]), s[6], s[7])
    return tuple(hit), blocked


def merged_launch(bvh: ResidentBVH, rays, n_closest: int):
    """One merged K1 launch over a packed (8, N) operand whose first
    ``n_closest`` lanes (whole blocks) are the closest queue. Returns
    ((t, row, u, v), blocked) as ``merged_plain`` does."""
    global merged_launches
    rays = rays.contiguous()
    out = _launch(bvh, tuple(rays[0:6]), rays[6], rays[7], n_closest // BLOCK)
    merged_launches += 1
    return out


def merged(comps_c, tmin_c, tmax_c, comps_s, tmin_s, tmax_s, block: int,
           sort, plain, launch):
    """What the merged modes of K1, K2 and K4 share. ``comps_*`` are (ox,
    oy, oz, dx, dy, dz). Each queue is packed and padded to whole blocks of
    ``block`` with dead lanes (tmax = 0); ``sort`` (a packed operand ->
    (sorted, inv), or None) coherence-sorts each half on its own; ``plain``
    runs on a CPU operand and ``launch`` on a CUDA one (both (rays,
    n_closest) -> ((t, row, u, v), blocked)); each half is unsorted BEFORE
    it is cut to its caller's lanes (sorted order moves dead and padding
    lanes last). Returns ((t, row, u, v), blocked)."""
    rays_c, n = pack_rays(Vec3(*comps_c[0:3]), Vec3(*comps_c[3:6]), tmin_c,
                          tmax_c, block)
    rays_s, n2 = pack_rays(Vec3(*comps_s[0:3]), Vec3(*comps_s[3:6]), tmin_s,
                           tmax_s, block)
    if sort is not None:
        rays_c, inv_c = sort(rays_c)
        rays_s, inv_s = sort(rays_s)
    rays = torch.cat([rays_c, rays_s], dim=1)
    if rays.device.type == "cpu":
        out, blocked = plain(rays, rays_c.shape[1])
    elif rays.device.type == "cuda":
        out, blocked = launch(rays, rays_c.shape[1])
    else:
        raise ValueError(f"no traversal for device {rays.device}")
    if sort is not None:
        out = tuple(_uncompact(x, inv_c) for x in out)
        blocked = _uncompact(blocked, inv_s)
    return tuple(x[:n] for x in out), blocked[:n2]


def closest_and_occluded_resident(bvh: ResidentBVH, comps_c, tmin_c, tmax_c,
                                  comps_s, tmin_s, tmax_s,
                                  compact: bool = False):
    """The closest hits of one queue and the any-hit flags of another in
    ONE K1 launch (the wavefront's extension rays and the previous
    bounce's deferred shadow rays), through ``merged``; ``compact``
    coherence-sorts each half over the root box, and the results come
    back in the caller's order. Returns (Hit of the closest queue, blocked
    flags of the shadow queue)."""
    lo, hi = bvh.bounds[0, 0:3], bvh.bounds[0, 3:6]
    (t, row, u, v), blocked = merged(
        comps_c, tmin_c, tmax_c, comps_s, tmin_s, tmax_s, BLOCK,
        (lambda r: _compact(r, lo, hi)) if compact else None,
        lambda r, k: merged_plain(bvh, r, k),
        lambda r, k: merged_launch(bvh, r, k))
    return Hit(t=t, tri=row, u=u, v=v), blocked
