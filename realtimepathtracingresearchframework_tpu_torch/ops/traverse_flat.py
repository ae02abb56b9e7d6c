"""Flat-cull traversal: the K2 and K3 kernels' wrappers and plain versions.

Counterpart of the reference's ``ops/traverse_pallas3.py``. Both kernels
return what the resident walk (K1, ``ops/traverse_resident.py``) returns,
the closest hit (t, row, u, v) or an any-hit blocked flag, without walking
the tree:

- **K2** (``closest_hit_flat`` / ``occluded_flat``; reference
  ``_kernel3``): every group of ``CULL`` (128) consecutive lanes tests
  its union packet box (origin box x inverse-direction box, the
  conservative interval test of ``_kernel3``) against every leaf AABB;
  each lane then tests the group's survivors that its own exact slab test
  enters (``plain_flat``). The reference tests every survivor for every
  lane of the group (``plain_group``, kept as the reference function for
  the tests); the two differ only on grazing lanes (``grazing``).
- **K3** (``closest_hit_precull`` / ``occluded_precull``; reference
  ``_kernel4`` with its feeder ``leaf_masks_xla``): the reference's
  survivors are the OR over the group of each lane's own exact slab test
  against every leaf (``precull_leaf_masks``); the port's K3 tests each
  lane's own leaves, the group of one lane (``plain_precull``), and the
  kernel caps each lane's box test at its best hit so far.

K2 also has the merged mode of the wavefront (``closest_and_occluded_flat``;
reference ``closest_and_occluded_pallas3``): one launch whose first lanes
run a closest queue and whose later lanes run a shadow queue.

The group test keeps every leaf a lane's slab test enters, and the flush
merges hits on (t, row) lexicographically, so either kernel's result
equals K1's bit for bit, whatever the group and the flush order.

On a CPU tensor the wrappers run the plain PyTorch version (``plain``).
On a CUDA tensor they launch the hand-written kernel
(``csrc/traverse_flat_cull.cu``, ``csrc/traverse_precull.cu``, built by
``kernels/build.py`` at first use) or raise; they never fall back to the
plain version there. ``launches_k2``/``launches_k3`` count the kernels'
launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import (
    T_MAX,
    safe_inv_dir,
    slab_interval,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import Hit
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    _check,
    _check_aligned,
    _compact,
    _uncompact,
    merged,
    pack_rays,
    pack_resident,
)

K2 = "traverse_flat_cull"  # csrc/traverse_flat_cull.cu
K3 = "traverse_precull"  # csrc/traverse_precull.cu
DEFAULT_BLOCK = 512
QUARTERS = 4  # default groups per block (traverse_pallas3.QUARTERS)
BIG = 3.0e38  # empty-box and dead-lane fill (traverse_pallas3.py:118)
ROW_NONE = 2**31 - 1  # "no hit yet" row of the lexicographic merge
_CHUNK_ELEMS = 1 << 23  # elements per temporary of the plain versions

# K3: a leaf that at least this many lanes of a warp hold is tested by each
# of them alone (broadcast loads), else the warp tests it for each holder in
# turn (csrc/traverse_precull.cu); above 32: never. Results do not depend on
# it; of 1, 8, 16, 24, 32 and never, 24 was within 1% of the fastest on
# every queue timed on an H100, at leaf size 32, 64 and 128 (PERF.md).
SCAN_FROM = 24
# K2's (csrc/traverse_flat_cull.cu): of 1, 8, 16, 24 and never, 16 was the
# fastest on the terrain200 and village primaries and the merged queue
# (PERF.md)
K2_SCAN_FROM = 16
LEAF_SIZES = (32, 64, 128)
# K2: lanes per broad-phase group, one block of csrc/traverse_flat_cull.cu.
# The result does not depend on it; of 32, 64 and 128, 128 was the fastest
# on the primaries, the queue the renderer gives K2 (PERF.md).
CULL = 128

launches_k2 = 0  # K2 launches in this process (reset with reset_launches)
launches_k3 = 0  # K3 launches in this process
merged_launches_k2 = 0  # of the K2 launches, merged two-queue ones


def reset_launches() -> None:
    global launches_k2, launches_k3, merged_launches_k2
    launches_k2 = launches_k3 = merged_launches_k2 = 0


class FlatBVH(NamedTuple):
    """The resident BVH (``ResidentBVH``'s fields, so K1 takes it too) plus
    the flat cull's leaf boxes and the scene box of the coherence sort."""

    bounds: torch.Tensor  # (M, 6) f32 node AABBs
    links: torch.Tensor  # (M, 2) i32 skip link, leaf index
    tri_rows: torch.Tensor  # (R, 9) f32 v0, e1, e2, leaf-major
    row_tri: torch.Tensor  # (R,) i32 source triangle of each row
    leaf_size: int
    real_rows: torch.Tensor  # (R // leaf_size,) i32 (K1 and K2 read it; K3 not)
    aabbs: torch.Tensor  # (16, Lpad) f32: rows 0-2 min, 3-5 max
    num_leaves: int
    scene_lo: torch.Tensor  # (3,) root node min
    scene_hi: torch.Tensor  # (3,) root node max

    @property
    def num_nodes(self) -> int:
        return self.bounds.shape[0]


def leaf_aabbs_for(tri_rows: np.ndarray, leaf_size: int) -> np.ndarray:
    """(16, Lpad) leaf boxes of the flat cull (traverse_pallas3.py:88-125):
    rows 0-2 min, 3-5 max of each leaf's rows, with v1 = v0 + e1 and
    v2 = v0 + e2 in f32; zero-padded rows inside a leaf count (they only
    loosen its box); padding columns up to a multiple of 128 get an empty
    box (min = +3e38 > max = -3e38) that no test passes."""
    rows = np.asarray(tri_rows, np.float32)[:, 0:9]
    num_leaves = rows.shape[0] // leaf_size
    v0 = rows[:, 0:3]
    v1 = v0 + rows[:, 3:6]
    v2 = v0 + rows[:, 6:9]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    lo = lo[: num_leaves * leaf_size].reshape(num_leaves, leaf_size, 3).min(1)
    hi = hi[: num_leaves * leaf_size].reshape(num_leaves, leaf_size, 3).max(1)
    lpad = -(-num_leaves // 128) * 128
    out = np.zeros((16, lpad), np.float32)
    out[0:3] = BIG
    out[3:6] = -BIG
    out[0:3, :num_leaves] = lo.T
    out[3:6, :num_leaves] = hi.T
    return out


def pack_flat(tb, device="cpu") -> FlatBVH:
    """ThreadedBVH (numpy) -> FlatBVH on ``device`` (pack_for_pallas3)."""
    res = pack_resident(tb, device)
    rows = np.asarray(tb.tri_rows, np.float32)
    return FlatBVH(
        *res,
        aabbs=torch.from_numpy(leaf_aabbs_for(rows, res.leaf_size)).to(device),
        num_leaves=rows.shape[0] // res.leaf_size,
        scene_lo=res.bounds[0, 0:3].clone(),
        scene_hi=res.bounds[0, 3:6].clone(),
    )


# ---------------------------------------------------------------------------
# Plain versions: the survivor masks and the flush
# ---------------------------------------------------------------------------


def group_bounds(rays: torch.Tensor, q: int) -> torch.Tensor:
    """(17, G) packet bounds of each q-lane group over its live lanes
    (traverse_pallas2.block_bounds): rows 0-2 origin min, 3-5 origin max,
    6-8 inverse-direction min, 9-11 inverse-direction max, 12 tmin min,
    13 tmax max, and rows 14-16 1.0 where a live lane's direction has a
    component of exactly 0 on that axis, else 0.0. An all-dead group gets
    tmax max <= tmin min."""
    r = rays.reshape(8, -1, q)
    live = r[7] > r[6]
    inv = safe_inv_dir(r[3:6])

    def mn(x):
        return torch.where(live, x, BIG).amin(dim=1)

    def mx(x):
        return torch.where(live, x, -BIG).amax(dim=1)

    out = [mn(r[k]) for k in range(3)] + [mx(r[k]) for k in range(3)]
    out += [mn(inv[k]) for k in range(3)] + [mx(inv[k]) for k in range(3)]
    out += [mn(r[6]), mx(r[7])]
    out += [(live & (r[3 + k] == 0.0)).any(dim=1).to(torch.float32)
            for k in range(3)]
    return torch.stack(out)


def flat_leaf_bounds(rays: torch.Tensor, aabbs: torch.Tensor, q: int,
                     exact_zero: bool = True):
    """K2's broad phase: ((G, Lpad) bool, (G, Lpad) f32), True where group
    g's union packet box may meet leaf l (the interval test of
    traverse_pallas3.py:187-226), and the test's lower end ``lb``, the
    entry bound the kernel sorts its survivors by: below the slab entry t
    (``slab_entry``) of every live lane of the group. An axis on which a
    live lane of the group has a zero direction component bounds nothing
    (that lane's slab is the whole line there, ``slab_interval``);
    ``exact_zero=False`` is the reference's test, which bounds it by the
    products with 1e20 (``plain_group`` and ``grazing`` only)."""
    b = group_bounds(rays, q)[:, :, None]  # (17, G, 1)
    tlo, thi = b[12], b[13]
    lb = tlo.expand(-1, aabbs.shape[1])
    u = thi.expand(-1, aabbs.shape[1])
    expand_ok = torch.ones_like(lb, dtype=torch.bool)
    for k in range(3):
        olo, ohi, ilo, ihi = b[k], b[3 + k], b[6 + k], b[9 + k]
        bmn, bmx = aabbs[k][None], aabbs[3 + k][None]
        alo, ahi = bmn - ohi, bmn - olo
        blo, bhi = bmx - ohi, bmx - olo
        t0lo = torch.minimum(torch.minimum(alo * ilo, alo * ihi),
                             torch.minimum(ahi * ilo, ahi * ihi))
        t0hi = torch.maximum(torch.maximum(alo * ilo, alo * ihi),
                             torch.maximum(ahi * ilo, ahi * ihi))
        t1lo = torch.minimum(torch.minimum(blo * ilo, blo * ihi),
                             torch.minimum(bhi * ilo, bhi * ihi))
        t1hi = torch.maximum(torch.maximum(blo * ilo, blo * ihi),
                             torch.maximum(bhi * ilo, bhi * ihi))
        lo_k = torch.minimum(t0lo, t1lo)
        hi_k = torch.maximum(t0hi, t1hi)
        ok_k = torch.maximum(alo, -bhi) <= thi
        if exact_zero:
            zero = b[14 + k] > 0.0
            lo_k = torch.where(zero, -float("inf"), lo_k)
            hi_k = torch.where(zero, float("inf"), hi_k)
            ok_k = ok_k | zero
        lb = torch.maximum(lb, lo_k)
        u = torch.minimum(u, hi_k)
        expand_ok = expand_ok & ok_k
    return (lb <= u) & expand_ok & (thi > tlo), lb


def flat_leaf_masks(rays: torch.Tensor, aabbs: torch.Tensor, q: int,
                    exact_zero: bool = True):
    """(G, Lpad) bool: the survivors of K2's broad phase
    (``flat_leaf_bounds``)."""
    return flat_leaf_bounds(rays, aabbs, q, exact_zero)[0]


def slab_entry(rays: torch.Tensor, aabbs: torch.Tensor):
    """(N, Lpad) f32 twice: each lane's slab entry and exit t of its
    segment [tmin, tmax] against every leaf box (traverse_pallas3.py:
    700-714, with ``slab_interval``'s zero-direction rule)."""
    tmin, tmax = rays[6], rays[7]
    tn = tmin[:, None].expand(-1, aabbs.shape[1])
    tf = tmax[:, None].expand(-1, aabbs.shape[1])
    inv = safe_inv_dir(rays[3:6])
    for k in range(3):
        tsmall, tbig = slab_interval(
            aabbs[k][None], aabbs[3 + k][None], rays[k][:, None],
            inv[k][:, None], (rays[3 + k] == 0.0)[:, None])
        tn = torch.maximum(tn, tsmall)
        tf = torch.minimum(tf, tbig)
    return tn, tf


def ray_leaf_hits(rays: torch.Tensor, aabbs: torch.Tensor) -> torch.Tensor:
    """(N, Lpad) bool: each lane's exact slab test of its own segment
    [tmin, tmax] against every leaf box (traverse_pallas3.py:700-714)."""
    tn, tf = slab_entry(rays, aabbs)
    valid = (aabbs[0] <= aabbs[3])[None]
    return (tn <= tf) & (rays[7] > rays[6])[:, None] & valid


def precull_leaf_masks(rays: torch.Tensor, aabbs: torch.Tensor, q: int):
    """K3's survivors, the plain ``leaf_masks_xla``: (G, Lpad) bool, the OR
    over each q-lane group of ``ray_leaf_hits``, in chunks of lanes (the
    whole (N, Lpad) test at 2M lanes would be GBs per temporary)."""
    n, lpad = rays.shape[1], aabbs.shape[1]
    step = max(q, (_CHUNK_ELEMS // lpad) // q * q)
    out = [
        ray_leaf_hits(rays[:, s:s + step], aabbs).reshape(-1, q, lpad).any(1)
        for s in range(0, n, step)
    ]
    return torch.cat(out)


def _flush(bvh: FlatBVH, rays: torch.Tensor, mask: torch.Tensor, q: int,
           any_hit: bool):
    """Möller-Trumbore of every (group, surviving leaf) pair over the
    group's q lanes and the leaf's rows, in the expression order of
    ``traverse_pallas2._mt_leaf``. Hits merge on (t, row)
    lexicographically, the order-independent merge of ``_mt_leaf``.
    Returns (t, row, u, v) or the blocked flags, per lane of ``rays``."""
    n, dev, ls = rays.shape[1], rays.device, bvh.leaf_size
    pairs = torch.nonzero(mask[:, : bvh.num_leaves])
    lane_iota = torch.arange(q, device=dev)
    sub_iota = torch.arange(ls, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    t_best = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    row_best = torch.full((n,), ROW_NONE, dtype=torch.int64, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    step = max(1, _CHUNK_ELEMS // (q * ls))
    for s in range(0, pairs.shape[0], step):
        group, leaf = pairs[s:s + step, 0], pairs[s:s + step, 1]
        lanes = group[:, None] * q + lane_iota  # (c, q)
        row0 = leaf * ls
        rows = bvh.tri_rows[row0[:, None] + sub_iota][:, None]  # (c, 1, ls, 9)
        r = [rays[k][lanes][:, :, None] for k in range(8)]  # (c, q, 1)
        ok, uu, vv, tt = traverse._mt_rows(rows, *r[0:6])
        hit = ok & (tt > r[6]) & (tt < r[7])
        if any_hit:
            blocked[lanes[hit.any(dim=-1)]] = True
            continue
        tt = torch.where(hit, tt, T_MAX)
        t_leaf = tt.amin(dim=-1)
        sub = torch.where(hit & (tt <= t_leaf[..., None]), sub_iota, ls).amin(-1)
        found = sub < ls
        pick = torch.clamp(sub, max=ls - 1)[..., None]
        cl = lanes[found]
        ct = t_leaf[found]
        crow = (row0[:, None] + sub)[found]
        cu = uu.gather(-1, pick)[..., 0][found]
        cv = vv.gather(-1, pick)[..., 0][found]
        # lexicographic (t, row) minimum per lane within the chunk ...
        m_t = torch.full_like(t_best, T_MAX).scatter_reduce(
            0, cl, ct, "amin")
        at_t = ct == m_t[cl]
        m_row = torch.full_like(row_best, ROW_NONE).scatter_reduce(
            0, cl[at_t], crow[at_t], "amin")
        win = at_t & (crow == m_row[cl])
        cl, ct, crow, cu, cv = cl[win], ct[win], crow[win], cu[win], cv[win]
        # ... then against the lanes' best so far
        better = (ct < t_best[cl]) | ((ct == t_best[cl]) & (crow < row_best[cl]))
        cl = cl[better]
        t_best[cl] = ct[better]
        row_best[cl] = crow[better]
        u_best[cl] = cu[better]
        v_best[cl] = cv[better]
    if any_hit:
        return blocked
    miss = row_best == ROW_NONE
    return (
        torch.where(miss, T_MAX, t_best),
        torch.where(miss, -1, row_best).to(torch.int32),
        u_best,
        v_best,
    )


def _cat(out, any_hit):
    return torch.cat(out) if any_hit else tuple(map(torch.cat, zip(*out)))


def plain_precull(bvh: FlatBVH, rays: torch.Tensor, any_hit: bool):
    """K3's plain version: each lane's own survivors (``ray_leaf_hits``,
    ``precull_leaf_masks`` at q = 1), then ``_flush``, in chunks of lanes.
    Equal to ``_flush`` over the q-lane groups' OR bit for bit, whatever
    q."""
    step = max(1, _CHUNK_ELEMS // bvh.aabbs.shape[1])
    return _cat([_flush(bvh, rays[:, s:s + step],
                        ray_leaf_hits(rays[:, s:s + step], bvh.aabbs), 1,
                        any_hit)
                 for s in range(0, rays.shape[1], step)], any_hit)


def plain_flat(bvh: FlatBVH, rays: torch.Tensor, any_hit: bool):
    """K2's plain version, in chunks of lanes: the broad phase over groups
    of ``CULL`` lanes (``flat_leaf_masks``; a last, partial group padded
    with dead lanes), expanded to the lanes, AND each lane's own slab test
    (``ray_leaf_hits``), then ``_flush`` per lane (q = 1). Every leaf a
    lane's slab test enters survives its group's test (the entry bound
    argument of csrc/flat_cull.cuh), so this equals ``plain_precull`` and
    K1 wherever the group test's extra cull keeps those leaves; it differs
    from the reference function, ``plain_group``, only on grazing lanes
    (``grazing``)."""
    n, lpad = rays.shape[1], bvh.aabbs.shape[1]
    rays = torch.nn.functional.pad(rays, (0, -n % CULL))
    step = max(CULL, (_CHUNK_ELEMS // lpad) // CULL * CULL)
    out = []
    for s in range(0, rays.shape[1], step):
        r = rays[:, s:s + step]
        mask = flat_leaf_masks(r, bvh.aabbs, CULL).repeat_interleave(CULL, 0)
        out.append(_flush(bvh, r, mask & ray_leaf_hits(r, bvh.aabbs), 1,
                          any_hit))
    out = _cat(out, any_hit)
    return out[:n] if any_hit else tuple(x[:n] for x in out)


def plain_group(bvh: FlatBVH, rays: torch.Tensor, q: int, any_hit: bool):
    """The reference's function of K2 (``_kernel3``): every leaf that
    survives a q-lane group's broad phase tested for every lane of the
    group (``flat_leaf_masks`` then ``_flush``). The tests and
    ``chip_smoke.py`` hold K2 against it (``grazing``); no route runs it."""
    return _flush(bvh, rays, flat_leaf_masks(rays, bvh.aabbs, q, False), q,
                  any_hit)


def grazing(bvh: FlatBVH, rays: torch.Tensor, lanes: torch.Tensor, q: int,
            ref, any_hit: bool) -> list:
    """Whether each lane of ``lanes``, where K2 (``plain_flat``) and the
    reference function (``plain_group`` at q, its result ``ref``: (t, row,
    u, v) or blocked flags) differ, is grazing: the reference's hit lies in
    a leaf of the group's survivors whose box the lane's own exact slab
    test misses (a box corner, a 1-ulp gap between the slab t and
    Möller-Trumbore's t, or a leaf that the reference's broad phase keeps
    for its group although the lane's test rejects it). Closest mode:
    the leaf of the reference's hit row; any-hit: some surviving leaf that
    the slab test misses blocks the lane's segment."""
    out = []
    for j in lanes.tolist():
        r = rays[:, j:j + 1]
        own = ray_leaf_hits(r, bvh.aabbs)[0]
        if any_hit:
            survive = flat_leaf_masks(rays[:, j // q * q:(j // q + 1) * q],
                                      bvh.aabbs, q, False)[0]
            out.append(bool(ref[j]) and bool(_flush(
                bvh, r, (survive & ~own)[None], 1, True)[0]))
        else:
            row = int(ref[1][j])
            out.append(row >= 0 and not bool(own[row // bvh.leaf_size]))
    return out


def plain(name: str, bvh: FlatBVH, rays: torch.Tensor, q: int,
          any_hit: bool):
    """The plain version of K2 (``plain_flat``) or K3 (``plain_precull``)
    on a packed (8, Np) operand; ``q`` does not count. What the wrappers
    run on CPU tensors, and what ``launch`` must equal on the card."""
    if name == K3:
        return plain_precull(bvh, rays, any_hit)
    return plain_flat(bvh, rays, any_hit)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _lib(name: str):
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    lib = build.load(name)
    fn = getattr(lib, f"rptr_{name}")
    # every pointer and the stream as c_void_p (a bare Python int would be
    # passed as a 32-bit C int and cut the pointer)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, p, i, p, i, i, i] + [p] * 5 + [p] + (
        [i] if name == K3 else [p, i])
    fn.restype = ctypes.c_int
    lib.rptr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rptr_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def bind(name: str, bvh: FlatBVH, rays: torch.Tensor, q: int, n_closest: int,
         mode: int, scan_from: int = None):
    """Check the operands of one launch of K2 or K3 over a packed (8, Np)
    operand, allocate its outputs and bind it: K2 in broad-phase groups of
    ``CULL`` lanes, K3 in blocks of up to 512 lanes; the closest mode on
    lanes [0, n_closest), the any-hit mode on the rest (K2's split between
    two groups). ``mode`` is the kernel's own argument: K2's first any-hit
    q-lane group, K3's any-hit flag (K3 runs one mode per launch);
    ``scan_from`` forces how a leaf is served (default ``K2_SCAN_FROM`` or
    ``SCAN_FROM``) and does not change the result. Returns (run,
    (t, row, u, v) of the closest lanes, blocked flags of the rest):
    ``run()`` launches the kernel on the current device, uncounted, and
    returns its CUDA error code (0 = launched); None when there is no
    lane."""
    dev = rays.device
    n = rays.shape[1]
    ls, lpad = bvh.leaf_size, bvh.aabbs.shape[1]
    r = bvh.tri_rows.shape[0]
    _check("aabbs", bvh.aabbs, torch.float32, (16, lpad), dev)
    _check("tri_rows", bvh.tri_rows, torch.float32, (r, 9), dev)
    _check("rays", rays, torch.float32, (8, n), dev)
    if n % q or q % 32 or not 0 < q <= 1024:
        raise ValueError(f"{name}: {n} lanes in groups of {q}")
    if n_closest % q or not 0 <= n_closest <= n:
        raise ValueError(f"{name}: a closest part of {n_closest} of {n} lanes")
    if ls not in LEAF_SIZES:
        raise ValueError(f"{name}: leaf size {ls} not in {LEAF_SIZES}")
    # a lane reads its ls / 32 rows in loads of 4 * ls / 32 bytes
    _check_aligned("tri_rows", bvh.tri_rows, 4 * ls // 32)
    if scan_from is not None:
        sf = scan_from
    else:
        sf = K2_SCAN_FROM if name == K2 else SCAN_FROM
    if name == K3:
        extra = (sf,)
    else:
        _check("real_rows", bvh.real_rows, torch.int32, (r // ls,), dev)
        if 0 < n_closest < n and n_closest % CULL:
            raise ValueError(f"{name}: a merged split at lane {n_closest} "
                             f"inside a broad-phase group of {CULL}")
        extra = (bvh.real_rows.data_ptr(), sf)
    closest = (torch.empty(n_closest, dtype=torch.float32, device=dev),
               torch.empty(n_closest, dtype=torch.int32, device=dev),
               torch.empty(n_closest, dtype=torch.float32, device=dev),
               torch.empty(n_closest, dtype=torch.float32, device=dev))
    blocked = torch.empty(n - n_closest, dtype=torch.bool, device=dev)
    if n == 0:
        return None, closest, blocked
    _, fn = _lib(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    args = (bvh.aabbs.data_ptr(), lpad, bvh.num_leaves, bvh.tri_rows.data_ptr(),
            ls, rays.data_ptr(), n, q, mode,
            *(x.data_ptr() or None for x in (*closest, blocked)), stream,
            *extra)

    def run():
        return fn(*args)

    return run, closest, blocked


def _launch(name: str, bvh: FlatBVH, rays: torch.Tensor, q: int,
            n_closest: int, mode: int, scan_from: int = None):
    """One launch of K2 or K3 (``bind``'s arguments), counted. Returns
    ((t, row, u, v), blocked) of the two parts, raw."""
    global launches_k2, launches_k3
    run, closest, blocked = bind(name, bvh, rays, q, n_closest, mode, scan_from)
    if run is None:
        return closest, blocked
    with torch.cuda.device(rays.device):
        rc = run()
    if rc != 0:
        msg = _lib(name)[0].rptr_cuda_error_string(rc).decode()
        if name == K2:  # the survivor list: 8 bytes a leaf, at most 47 KB
            msg += f"; {bvh.num_leaves} leaves"
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")
    if name == K2:
        launches_k2 += 1
    else:
        launches_k3 += 1
    return closest, blocked


def launch(name: str, bvh: FlatBVH, rays: torch.Tensor, q: int,
           any_hit: bool, scan_from: int = None):
    """One launch of K2 or K3 over a packed (8, Np) operand in one mode
    (``scan_from``: ``bind``'s). Returns the raw output tensors:
    (t, row, u, v) or the blocked flags."""
    n_closest = 0 if any_hit else rays.shape[1]
    closest, blocked = _launch(name, bvh, rays, q, n_closest,
                               int(any_hit) if name == K3 else n_closest // q,
                               scan_from)
    return blocked if any_hit else closest


def merged_plain(bvh: FlatBVH, rays: torch.Tensor, q: int, n_closest: int):
    """The plain version of a merged K2 launch: plain K2 closest on lanes
    [0, n_closest), plain K2 any-hit on the rest. Returns ((t, row, u, v),
    blocked)."""
    return (plain(K2, bvh, rays[:, :n_closest], q, False),
            plain(K2, bvh, rays[:, n_closest:], q, True))


def merged_launch(bvh: FlatBVH, rays: torch.Tensor, q: int, n_closest: int):
    """One merged K2 launch; returns what ``merged_plain`` returns."""
    global merged_launches_k2
    out = _launch(K2, bvh, rays.contiguous(), q, n_closest, n_closest // q)
    merged_launches_k2 += 1
    return out


def _dispatch(name, bvh: FlatBVH, ro, rd, t_min, t_max, block, groups,
              compact, any_hit):
    if block % (groups * 128):
        raise ValueError(
            f"flat-cull block must be a multiple of {groups * 128} "
            f"(groups of 128-lane multiples), got {block}"
        )
    q = block // groups
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    if compact:
        rays, inv = _compact(rays, bvh.scene_lo, bvh.scene_hi)
    if rays.device.type == "cpu":
        out = plain(name, bvh, rays, q, any_hit)
    elif rays.device.type == "cuda":
        out = launch(name, bvh, rays.contiguous(), q, any_hit)
    else:
        raise ValueError(f"no traversal for device {rays.device}")
    if any_hit:
        return (_uncompact(out, inv) if compact else out)[:n]
    if compact:
        out = tuple(_uncompact(x, inv) for x in out)
    t, row, u, v = (x[:n] for x in out)
    return Hit(t=t, tri=row, u=u, v=v)


def closest_hit_flat(bvh: FlatBVH, ro, rd, t_min=0.0, t_max=T_MAX,
                     block: int = DEFAULT_BLOCK, groups: int = QUARTERS,
                     compact: bool = False) -> Hit:
    """K2 closest hit (closest_hit_pallas3); ``tri`` is the BVH row."""
    return _dispatch(K2, bvh, ro, rd, t_min, t_max, block, groups, compact,
                     any_hit=False)


def occluded_flat(bvh: FlatBVH, ro, rd, t_min=0.0, t_max=T_MAX,
                  block: int = DEFAULT_BLOCK, groups: int = QUARTERS,
                  compact: bool = False) -> torch.Tensor:
    """K2 any-hit visibility (occluded_pallas3)."""
    return _dispatch(K2, bvh, ro, rd, t_min, t_max, block, groups, compact,
                     any_hit=True)


def closest_hit_precull(bvh: FlatBVH, ro, rd, t_min=0.0, t_max=T_MAX,
                        block: int = DEFAULT_BLOCK, groups: int = QUARTERS,
                        compact: bool = False) -> Hit:
    """K3 closest hit (closest_hit_pallas4); ``tri`` is the BVH row."""
    return _dispatch(K3, bvh, ro, rd, t_min, t_max, block, groups, compact,
                     any_hit=False)


def occluded_precull(bvh: FlatBVH, ro, rd, t_min=0.0, t_max=T_MAX,
                     block: int = DEFAULT_BLOCK, groups: int = QUARTERS,
                     compact: bool = False) -> torch.Tensor:
    """K3 any-hit visibility (occluded_pallas4)."""
    return _dispatch(K3, bvh, ro, rd, t_min, t_max, block, groups, compact,
                     any_hit=True)


def closest_and_occluded_flat(bvh: FlatBVH, comps_c, tmin_c, tmax_c, comps_s,
                              tmin_s, tmax_s, block: int = DEFAULT_BLOCK,
                              groups: int = QUARTERS, compact: bool = False):
    """K2's merged mode (closest_and_occluded_pallas3, :1119): the closest
    hits of one queue and the any-hit flags of another in ONE launch,
    through ``traverse_resident.merged``; ``compact`` coherence-sorts each
    half on its own (traverse_pallas3.py:1140-1160), and the results come
    back in the caller's order. Returns (Hit of the closest queue, blocked
    flags)."""
    if block % (groups * 128):
        raise ValueError(
            f"flat-cull block must be a multiple of {groups * 128} "
            f"(groups of 128-lane multiples), got {block}"
        )
    q = block // groups
    (t, row, u, v), blocked = merged(
        comps_c, tmin_c, tmax_c, comps_s, tmin_s, tmax_s, block,
        (lambda r: _compact(r, bvh.scene_lo, bvh.scene_hi)) if compact else None,
        lambda r, k: merged_plain(bvh, r, q, k),
        lambda r, k: merged_launch(bvh, r, q, k))
    return Hit(t=t, tri=row, u=u, v=v), blocked
