"""Subtree-binned streamed traversal: the K5 kernel's wrappers, plain
version and round driver.

Counterpart of the reference's ``ops/traverse_binned.py``. Instead of
walking the top tree per ray, the dispatch computes every ray's entry t
into every subtree box once (``_entry_table``), then runs ROUNDS: each live
ray picks its nearest unvisited subtree in front of its best hit
(``_next_subtree``), the rays are counting-sorted into block-aligned
subtree bins (``_bin_layout``, ``_pad_operand``), and K5 walks each block
against exactly ONE subtree, seeded with the rays' best so far. After the
rounds, rays that still have a candidate subtree in front of their best
take one cleanup dispatch through K4 (``ops/traverse_stream.py``) with
their best t as the segment end; a cleanup hit replaces the best only when
strictly nearer. Closest hits agree with K4's except on exact-t ties
across subtrees, where K5 keeps the first subtree in (entry t, id) order.

The multislot dispatch (``closest_hit_binned_all``; reference
``_run_multislot``) gives every ray one slot per subtree it enters, up to
``K_MAX``, runs all slots in ONE K5 launch and merges them per ray; rays
past ``K_MAX`` slots finish in a K4 cleanup.

K5 itself (``plain`` / ``launch``; reference ``_kernel_binned``), per lane
of a block whose subtree is ``sid``: seed t = min(t_in, tmax) and the
incoming row, u, v; if ``sid >= 0`` walk subtree ``sid`` with the
threaded walk and Möller-Trumbore of K4, keeping strictly nearer hits
(closest mode), or stop at the first hit and mark the lane with the
subtree's first global row ``sid * L * 128`` (any-hit mode; a lane that
arrives blocked stays as it is); write t = min(t_in, tmax) where a row was
found, else 2e32, and the row, u, v. The reference's int32 bit-cast row
inside the float operand is not carried over: rows ride an int32 tensor
beside the floats.

On a CPU tensor the wrappers run ``plain`` (and K4's plain version); on a
CUDA tensor they launch ``csrc/traverse_binned.cu`` (and K4) or raise; the
kernel reads f32 or 16-bit quantized tiles. It walks each lane's subtree
as K4 walks one (``csrc/tlas_walk.cuh``: resumable per-lane walks whose
entered leaves the warp tests together, a leaf that ``SCAN_FROM`` or more
lanes of a warp hold scanned by each of them alone). ``launches_k5``
counts K5's launches.
"""

from __future__ import annotations

import ctypes

import torch

from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_stream as ts
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import (
    T_MAX,
    safe_inv_dir,
    slab_interval,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import Hit
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    _check,
    inverse_permutation,
    pack_rays,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_stream import (
    LEAF,
    StreamedBVHBuffers,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3
from realtimepathtracingresearchframework_tpu_torch.utils.profiling import (
    host_sync,
)

KERNEL = "traverse_binned"  # csrc/traverse_binned.cu
DEFAULT_BLOCK = 512
DEFAULT_ROUNDS = 2
# a leaf that this many lanes of a warp hold is scanned by each of them
# alone, else the warp tests it (> 32: never); measured on K5's queues
SCAN_FROM = 24
_INF = T_MAX

K_MAX = 8  # multislot slots per ray (traverse_binned.py:552)

launches_k5 = 0  # K5 launches in this process (reset with reset_launches)
multislot_dispatches = 0  # multislot dispatches since reset_launches
_overflow = {}  # device -> (2,) i64: overflow rays, live rays of them


def reset_launches() -> None:
    global launches_k5, multislot_dispatches
    launches_k5 = multislot_dispatches = 0
    _overflow.clear()


# ---------------------------------------------------------------------------
# Binning (traverse_binned.py:85-197), plain tensor code
# ---------------------------------------------------------------------------


def subtree_bounds(bb: StreamedBVHBuffers) -> torch.Tensor:
    """(S, 8) f32: row s is subtree s's top-tree leaf row [min3, max3,
    skip, s] (a top leaf's payload is its subtree id). Each boolean mask's
    index reads its count back (``host_sync("subtree_rows")``)."""
    top = bb.top_nodes
    sid = top[:, 7].to(torch.int64)
    leaf = sid >= 0
    out = torch.zeros((bb.num_subtrees, 8), dtype=torch.float32,
                      device=top.device)
    with host_sync("subtree_rows"):
        rows = sid[leaf]
    with host_sync("subtree_rows"):
        out[rows] = top[leaf]
    return out


def _entry_table(sb: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """(S, N) entry t of each ray's segment [tmin, tmax] into each subtree
    box; 2e32 where it misses, and for dead lanes (tmax <= tmin)."""
    ro = rays[0:3][:, None, :]  # (3, 1, N)
    inv = safe_inv_dir(rays[3:6])[:, None, :]
    zero = (rays[3:6] == 0.0)[:, None, :]
    tmin, tmax = rays[6], rays[7]
    bmin = sb[:, 0:3].T[:, :, None]  # (3, S, 1)
    bmax = sb[:, 3:6].T[:, :, None]
    tsmall, tbig = slab_interval(bmin, bmax, ro, inv, zero)  # (3, S, N)
    lo = tsmall.amax(dim=0)  # (S, N)
    hi = tbig.amin(dim=0)
    entry = torch.maximum(lo, tmin[None])
    ok = (hi >= entry) & (entry <= tmax[None]) & (tmax > tmin)[None]
    return torch.where(ok, entry, _INF)


def _next_subtree(entry, last_e, last_s, cap):
    """Each ray's next subtree in (entry t, sid) order after (last_e,
    last_s), among those entered before ``cap``. Returns (sid (N,) i32,
    -1 when none is left; its entry t)."""
    s = entry.shape[0]
    sid_iota = torch.arange(s, dtype=torch.int32, device=entry.device)[:, None]
    later = (entry > last_e[None]) | (
        (entry == last_e[None]) & (sid_iota > last_s[None]))
    e = torch.where(later & (entry < cap[None]), entry, _INF)
    mt = e.amin(dim=0)
    sid = torch.where(e <= mt[None], sid_iota, s).amin(dim=0)
    return torch.where(mt < _INF, sid, -1).to(torch.int32), mt


def _bin_layout(sid, s: int, block: int, n_pad: int):
    """Counting-sort layout of block-aligned subtree bins (dead bin last):
    (perm (N,) sorted source order, spos (n_pad,) sorted-order index of
    each padded slot (clamped), valid (n_pad,) slot holds a source lane,
    pos (N,) padded slot of each source lane, sid_blk (n_pad // block,)
    i32 each block's subtree or -1). Stable, so the caller's lane order
    holds inside a bin."""
    n, dev = sid.shape[0], sid.device
    b = torch.where(sid < 0, s, sid).to(torch.int64)
    perm = torch.argsort(b, stable=True)
    rank = inverse_permutation(perm)
    b_sorted = b[perm].contiguous()
    bins = torch.arange(s + 1, device=dev)
    start = torch.searchsorted(b_sorted, bins, side="left")
    end = torch.searchsorted(b_sorted, bins, side="right")
    counts = end - start
    padded = (counts + block - 1) // block * block
    pstart = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(padded, 0)[:-1]])
    pos = pstart[b] + (rank - start[b])
    with host_sync("bin_fill"):  # a copy to the device that waits
        n_pad_t = torch.tensor([n_pad], device=dev)
    fill = torch.cat([pstart[1:], n_pad_t])
    slot = torch.arange(n_pad, device=dev)
    bin_of = torch.searchsorted(fill, slot, side="right")
    bin_c = torch.clamp(bin_of, max=s)
    off = slot - pstart[bin_c]
    valid = (bin_of <= s) & (off < counts[bin_c])
    spos = torch.clamp(start[bin_c] + off, max=n - 1)
    blk_start = torch.arange(n_pad // block, device=dev) * block
    bin_of_blk = torch.searchsorted(fill, blk_start, side="right")
    used = blk_start < (pstart + padded)[torch.clamp(bin_of_blk, max=s)]
    sid_blk = torch.where((bin_of_blk >= s) | ~used, -1, bin_of_blk)
    return perm, spos, valid, pos, sid_blk.to(torch.int32)


def _pad_operand(stack, init_padded, perm, spos, valid):
    """A (rows, N) source stack moved into bin-padded slot order; padding
    slots take ``init_padded``'s values."""
    return torch.where(valid[None, :], stack[:, perm[spos]], init_padded)


def _coherence_perm(bb: StreamedBVHBuffers, rays):
    """One (octant, origin morton) ordering, dead lanes last, so stable
    binning keeps each bin's blocks octant-pure and origin-local. Returns
    (rays_sorted, inv)."""
    perm, inv = ts.coherence_order(
        ts._coherence_key(bb, tuple(rays[0:6])), ~(rays[7] > rays[6]))
    return rays[:, perm], inv


# ---------------------------------------------------------------------------
# Plain version of K5 and the kernel launch
# ---------------------------------------------------------------------------


def plain(bb: StreamedBVHBuffers, sid_blk, rays, best, block: int,
          any_hit: bool):
    """The plain version of K5 on a bin-padded (8, n_pad) operand and its
    incoming best (t, row, u, v): each bin's lanes walk their subtree with
    the port's plain threaded walk, capped at min(t_in, tmax). Returns
    (t, row, u, v)."""
    t_in, row, u, v = (x.clone() for x in best)
    tb = torch.minimum(t_in, rays[7])
    L = bb.sub_leaves
    sid_lane = sid_blk.to(torch.int64).repeat_interleave(block)
    for s in torch.unique(sid_blk).tolist():
        if s < 0:
            continue
        lanes = torch.nonzero(sid_lane == s).squeeze(1)
        if any_hit:
            lanes = lanes[row[lanes] < 0]
        sub = ts.subtree_resident(bb, s)
        o, d = Vec3(*rays[0:3, lanes]), Vec3(*rays[3:6, lanes])
        if any_hit:
            blocked = traverse.occluded_threaded(sub, o, d, rays[6, lanes],
                                                 tb[lanes])
            row[lanes[blocked]] = s * L * LEAF
            continue
        h = traverse.closest_hit_threaded(sub, o, d, rays[6, lanes], tb[lanes])
        found = h.tri >= 0
        lf = lanes[found]
        tb[lf] = h.t[found]
        row[lf] = h.tri[found] + s * L * LEAF
        u[lf] = h.u[found]
        v[lf] = h.v[found]
    return torch.where(row < 0, _INF, tb), row, u, v


def _lib():
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    lib = build.load(KERNEL)
    # every pointer and the stream as c_void_p (a bare Python int would be
    # passed as a 32-bit C int and cut the pointer)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rptr_traverse_binned.argtypes = (
        [p, p, i, i, p, p, i, i, i, i] + [p] * 8 + [p, i])
    lib.rptr_traverse_binned.restype = ctypes.c_int
    lib.rptr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rptr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(bb: StreamedBVHBuffers, sid_blk, rays, best, block: int,
           any_hit: bool, scan_from: int = None):
    """One K5 launch over a bin-padded (8, n_pad) operand, one lane per
    ray, as ``plain`` computes it, each block's subtree node block staged
    in shared memory. ``scan_from`` (default ``SCAN_FROM``) forces the leaf
    service; it does not change the result. Returns the new (t, row, u,
    v)."""
    global launches_k5
    dev = rays.device
    n = rays.shape[1]
    ts.check_buffers(bb, dev)
    _check("rays", rays, torch.float32, (8, n), dev)
    if block % 128 or n % block:
        raise ValueError(f"{KERNEL}: {n} lanes in bin blocks of {block}")
    _check("sid_blk", sid_blk, torch.int32, (n // block,), dev)
    for k, x, dt in zip(("t", "row", "u", "v"), best,
                        (torch.float32, torch.int32, torch.float32,
                         torch.float32)):
        _check(k, x, dt, (n,), dev)
    out = tuple(torch.empty_like(x) for x in best)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rptr_traverse_binned(
            bb.sub_nodes.data_ptr(), bb.tri_tiles.data_ptr(),
            bb.sub_node_rows, bb.sub_leaves, sid_blk.data_ptr(),
            rays.data_ptr(), n, block, int(any_hit), int(bb.quantized),
            *(x.data_ptr() for x in best), *(x.data_ptr() for x in out),
            stream, SCAN_FROM if scan_from is None else scan_from,
        )
    if rc != 0:
        msg = lib.rptr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{KERNEL} launch failed: {msg} (cudaError {rc})")
    launches_k5 += 1
    return out


def _dispatch(bb, sid_blk, rays, best, block, any_hit, plain_versions):
    if plain_versions or rays.device.type == "cpu":
        return plain(bb, sid_blk, rays, best, block, any_hit)
    if rays.device.type == "cuda":
        return launch(bb, sid_blk, rays.contiguous(),
                      tuple(x.contiguous() for x in best), block, any_hit)
    raise ValueError(f"no traversal for device {rays.device}")


# ---------------------------------------------------------------------------
# Round driver (traverse_binned.py:474-549)
# ---------------------------------------------------------------------------


def padded_lanes(n: int, s: int, block: int) -> int:
    """Lanes of the bin-padded operand: room for n lanes in s + 1 bins
    (the dead bin last), each rounded up to whole blocks."""
    return ((n + (s + 1) * (block - 1)) // block + 1) * block


def miss_best(n: int, dev):
    """(t, row, u, v) of n lanes that have found nothing: t = 2e32,
    row = -1, u = v = 0."""
    return (
        torch.full((n,), _INF, dtype=torch.float32, device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.float32, device=dev),
        torch.zeros(n, dtype=torch.float32, device=dev),
    )


def round_operand(rays, best, sid, s: int, block: int, n_pad: int):
    """K5's operand for one round: the lanes of ``rays`` (8, N) and their
    best (t, row, u, v) moved into block-aligned subtree bins by ``sid``.
    Padding slots are dead rays (tmax = 0) with a miss-encoded best.
    Returns (sid_blk, rays (8, n_pad), best of n_pad lanes, pos)."""
    dev = rays.device
    perm, spos, valid, pos, sid_blk = _bin_layout(sid, s, block, n_pad)
    init_f = torch.zeros((11, 1), dtype=torch.float32, device=dev)
    init_f[8] = _INF
    init_row = torch.full((1, 1), -1, dtype=torch.int32, device=dev)
    floats = torch.cat([rays, best[0][None], best[2][None], best[3][None]])
    padded = _pad_operand(floats, init_f, perm, spos, valid)
    prow = _pad_operand(best[1][None], init_row, perm, spos, valid)[0]
    return sid_blk, padded[0:8], (padded[8], prow, padded[9], padded[10]), pos


def _run_rounds(bb: StreamedBVHBuffers, rays, block: int, rounds: int,
                shadow: bool, plain_versions: bool = False):
    """Coherence-sort once, run ``rounds`` binned rounds through K5, then
    one cleanup dispatch through K4 for the rays with a candidate subtree
    left in front of their best. Returns (t, row, u, v) in the caller's
    lane order, or the blocked flags when ``shadow``.
    ``plain_versions`` runs the plain versions of K5 and K4 on any device
    (the card's check of the kernels)."""
    n, dev = rays.shape[1], rays.device
    sb = subtree_bounds(bb)
    s = sb.shape[0]
    n_pad = padded_lanes(n, s, block)

    rays, inv = _coherence_perm(bb, rays)
    entry = _entry_table(sb, rays)
    best = miss_best(n, dev)
    last_e = torch.full((n,), -_INF, dtype=torch.float32, device=dev)
    last_s = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def cap_of(best):
        cap = torch.minimum(best[0], rays[7])
        if shadow:  # blocked lanes are done whatever their t
            cap = torch.where(best[1] >= 0, -_INF, cap)
        return cap

    for _ in range(rounds):
        sid, mt = _next_subtree(entry, last_e, last_s, cap_of(best))
        sid_blk, prays, pbest, pos = round_operand(rays, best, sid, s, block,
                                                   n_pad)
        out = _dispatch(bb, sid_blk, prays, pbest, block, shadow,
                        plain_versions)
        best = tuple(x[pos] for x in out)
        last_e = torch.where(sid >= 0, mt, _INF)
        last_s = torch.where(sid >= 0, sid, last_s)

    # cleanup: rays with an unvisited subtree still in front of the best
    cap = cap_of(best)
    sid, _ = _next_subtree(entry, last_e, last_s, cap)
    live = sid >= 0
    clean = torch.cat([rays[0:7], torch.where(live, cap, 0.0)[None]])
    k4 = ts.plain if plain_versions else ts.traverse_rays
    out = k4(bb, clean, any_hit=shadow)
    if shadow:
        return ((best[1] >= 0) | (live & out))[inv]
    improved = live & (out[1] >= 0)
    best = tuple(torch.where(improved, o, b) for o, b in zip(out, best))
    return tuple(x[inv] for x in best)


def multislot_operand(bb: StreamedBVHBuffers, rays, block: int,
                      k_max: int = None):
    """The multislot dispatch's K5 operand (traverse_binned.py:572-610):
    ``rays`` (8, N) coherence-sorted, then every ray given one SLOT per
    subtree box its segment enters, in subtree-id order, up to ``k_max``
    (``K_MAX``), slot k of ray i at source lane k*N + i, moved into
    block-aligned subtree bins (``round_operand``). Returns (sorted rays,
    inv, sid of each slot (k_max*N,) i32 -1 when empty, rays past k_max,
    sid_blk, slot rays, slot best, pos)."""
    k_max = K_MAX if k_max is None else k_max
    n, dev = rays.shape[1], rays.device
    sb = subtree_bounds(bb)
    s = sb.shape[0]
    rays, inv = _coherence_perm(bb, rays)
    entry = _entry_table(sb, rays)
    inside = entry < rays[7][None]  # entered within the ray's segment
    count = torch.cumsum(inside.to(torch.int32), dim=0)
    sid_iota = torch.arange(s, dtype=torch.int32, device=dev)[:, None]
    sid_dup = torch.cat([
        torch.where(inside & (count == k + 1), sid_iota, s).amin(dim=0)
        for k in range(k_max)])
    sid_dup = torch.where(sid_dup >= s, -1, sid_dup)
    overflow = count[-1] > k_max
    del entry, inside, count
    kn = k_max * n
    sid_blk, prays, pbest, pos = round_operand(
        rays.repeat(1, k_max), miss_best(kn, dev), sid_dup, s, block,
        padded_lanes(kn, s, block))
    return rays, inv, sid_dup, overflow, sid_blk, prays, pbest, pos


def _run_multislot(bb: StreamedBVHBuffers, rays, block: int,
                   k_max: int = None, plain_versions: bool = False):
    """The multislot closest hit (traverse_binned.py:556-663): all slots of
    all rays (``multislot_operand``) go through ONE closest K5 launch, each
    subtree's tiles shared by its bin's blocks. The slots' results merge
    per ray by a where-chain over the slots with strict ``<``, so the
    lowest slot keeps an exact-t tie (the reference's code; its docstring
    says scatter-min) and empty slots never win. Rays that enter more than
    ``k_max`` subtrees finish in a K4 cleanup over the whole pack with
    their segment capped at the merged t; a cleanup hit replaces the merged
    one when found. Returns (t, row, u, v) in the caller's lane order.
    ``plain_versions`` runs the plain versions of K5 and K4 on any device."""
    global multislot_dispatches
    k_max = K_MAX if k_max is None else k_max
    n, dev = rays.shape[1], rays.device
    rays, inv, sid_dup, overflow, sid_blk, prays, pbest, pos = (
        multislot_operand(bb, rays, block, k_max))
    out = _dispatch(bb, sid_blk, prays, pbest, block, False, plain_versions)
    del prays, pbest
    t_k, row_k, u_k, v_k = (x[pos].view(k_max, n) for x in out)
    t_k = torch.where(sid_dup.view(k_max, n) < 0, _INF, t_k)
    best_t, best_row, best_u, best_v = miss_best(n, dev)
    for k in range(k_max):
        better = (t_k[k] < best_t) & (row_k[k] >= 0)
        best_t = torch.where(better, t_k[k], best_t)
        best_row = torch.where(better, row_k[k], best_row)
        best_u = torch.where(better, u_k[k], best_u)
        best_v = torch.where(better, v_k[k], best_v)
    best = (torch.where(best_row < 0, _INF, best_t), best_row, best_u, best_v)

    # cleanup of the rays past k_max slots, capped by the merged best
    cap = torch.minimum(best[0], rays[7])
    clean = torch.cat([rays[0:7], torch.where(overflow, cap, 0.0)[None]])
    k4 = ts.plain if plain_versions else ts.traverse_rays
    out = k4(bb, clean, any_hit=False)
    improved = overflow & (out[1] >= 0)
    best = tuple(torch.where(improved, o, b) for o, b in zip(out, best))
    multislot_dispatches += 1
    live = (rays[7] > rays[6]).sum()
    _overflow[dev] = _overflow.get(dev, 0) + torch.stack(
        [overflow.sum(), live])
    return tuple(x[inv] for x in best)


def multislot_overflow():
    """(dispatches, overflow rays, live rays) of the multislot dispatches
    since ``reset_launches``, summed over devices (reads the device
    counts)."""
    counts = [c.tolist() for c in _overflow.values()]
    return (multislot_dispatches, sum(c[0] for c in counts),
            sum(c[1] for c in counts))


def closest_hit_binned_all(bb: StreamedBVHBuffers, ro: Vec3, rd: Vec3,
                           t_min=0.0, t_max=T_MAX,
                           block: int = DEFAULT_BLOCK, map_tri: bool = True,
                           k_max: int = None) -> Hit:
    """Closest hit through the single-launch multislot K5 dispatch and its
    K4 cleanup (traverse_binned.py:666)."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    best = _run_multislot(bb, rays, block, k_max)
    return ts._out_to_hit(bb, best, n, map_tri)


def closest_hit_binned(bb: StreamedBVHBuffers, ro: Vec3, rd: Vec3,
                       t_min=0.0, t_max=T_MAX, block: int = DEFAULT_BLOCK,
                       map_tri: bool = True,
                       rounds: int = DEFAULT_ROUNDS) -> Hit:
    """Closest hit through ``rounds`` binned rounds and the K4 cleanup."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    best = _run_rounds(bb, rays, block, rounds, shadow=False)
    return ts._out_to_hit(bb, best, n, map_tri)


def occluded_binned(bb: StreamedBVHBuffers, ro: Vec3, rd: Vec3, t_min=0.0,
                    t_max=T_MAX, block: int = DEFAULT_BLOCK,
                    rounds: int = DEFAULT_ROUNDS) -> torch.Tensor:
    """Any-hit visibility through ``rounds`` binned rounds and the K4
    cleanup: True where (t_min, t_max) is blocked."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    return _run_rounds(bb, rays, block, rounds, shadow=True)[:n]
