"""Resident two-level traversal: the K6 kernel's pack, wrappers and plain
version.

Counterpart of the reference's ``ops/traverse_tlas.py``. Every unique mesh
gets a threaded BLAS of 128-triangle leaves in object space, built once
(``pack_blas``, the reference's ``pack_blas_pallas``); each frame packs the
TLAS and the instance table around them (``pack_two_level``, the
reference's ``pack_two_level_pallas``). The layout, as the kernel reads it:

- ``tlas_nodes`` (Mt, 8) f32: [min3, max3, skip, instance id or -1], the
  links as float VALUES (exact below 2^24);
- ``blas_nodes`` (Mb, 8) f32: [min3, max3, skip, leaf id or -1], links
  BLAS-LOCAL float values, the leaf id ``leaf_row // 128`` within the mesh;
- ``inst_table`` (I, 16) f32: A^-1 (9, row-major), its translation (3),
  sigma_min(A), node_start, node_count, tile_base (exact ints as values);
- ``tri_tiles`` (Lt*16, 128) f32: leaf l of the whole set owns the
  field-major rows [l*16, l*16 + 16) (v0, e1, e2 xyz of its 128 triangles);
- ``row_tri`` (Lt*128,) i32: global row -> mesh-local triangle, a global
  row being ``(tile_base + leaf) * 128 + k``.

K6 (``closest_hit_tlas`` / ``occluded_tlas``; reference ``_kernel_tlas``)
walks the TLAS per ray in preorder with the slab test capped at its best
hit; at an entered instance it takes the ray to object space by A^-1
without renormalising the direction (object t is world t), walks the
instance's BLAS with the segment [tmin, t_best], and records the instance
where the walk found a strictly nearer hit. The first visited triangle
keeps an exact-t tie: instances in TLAS preorder, leaves in BLAS preorder,
the lower row inside a leaf. ``plain`` implements this with the port's
plain threaded walk, and ``csrc/traverse_tlas.cu`` must equal it bitwise.
The ordered (front-to-back) instance walk (``closest_hit_tlas(ordered=
True)``; reference traverse_tlas.py:372-431) visits each ray's instances
nearest first instead (``plain_ordered``, ``tlas.ordered_sweep``): equal
results except on exact-t ties across instances.

The kernel (``csrc/traverse_tlas.cu``, with K7 on ``csrc/tlas_walk.cuh``)
keeps each lane's walk as resumable state and lets the whole warp test
every entered leaf, 4 triangles a lane. Each block stages the TLAS in
shared memory, or the kernel reads it from global memory: ``launch``
picks by the TLAS's bytes (``top_staged``, the threshold
``STAGE_MAX_BYTES``, measured on the card) unless ``staged`` forces a
placement, and runs ``THREADS`` threads per block unless ``threads`` says
otherwise. The same rule and block size serve K7's top tree.

On a CPU tensor the wrappers run ``plain``; on a CUDA tensor they launch
the kernel (built by ``kernels/build.py`` at first use) or raise.
``launches_k6`` counts the kernel's launches, ``launches_k6_ordered`` and
``launches_k6_global`` those of its ordered walk and of its global
placement.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops.bvh import build_threaded_bvh
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops.tlas import (
    TwoLevelHit,
    _up,
    object_ray,
    ordered_sweep,
    sweep,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    ResidentBVH,
    real_row_counts,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    _check,
    _check_aligned,
    pack_rays,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

KERNEL = "traverse_tlas"  # csrc/traverse_tlas.cu
LEAF = 128
DEFAULT_BLOCK = 512
# the reference renderer's gate (traverse_tlas.py:61-62): TLAS + BLAS nodes
# and instances of its SMEM window; the renderer routes past them to K7
MAX_TOTAL_NODES = 1800
MAX_INSTANCES = 512

# K6's and K7's launch shape (csrc/tlas_walk.cuh), measured by
# chip_smoke.py phase 12 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# §6). THREADS per block: 128 was the fastest of 128, 256 and 512 on
# every queue of the instanced paths but the staged 160 KB top tree. Each
# block stages a top tree of up to STAGE_MAX_BYTES in shared memory, and a
# larger one is read from global memory: staged, K6's 32,032-byte TLAS
# (instanced500) ran 1-12% faster than from global memory, K7's
# 38,432-byte top tree (instanced600) within 4% either way (faster on some
# queues, slower on others), and its 160,032-byte one (instanced2500, one
# block per SM) 2.4x slower.
THREADS = 128
STAGE_MAX_BYTES = 36 * 1024

launches_k6 = 0  # K6 launches in this process (reset with reset_launches)
launches_k6_ordered = 0  # of which ordered (front-to-back) launches
launches_k6_global = 0  # of which read the TLAS from global memory


def reset_launches() -> None:
    global launches_k6, launches_k6_ordered, launches_k6_global
    launches_k6 = launches_k6_ordered = launches_k6_global = 0


def top_staged(nbytes: int) -> bool:
    """The placement of K6's TLAS and K7's top tree: every block stages a
    tree of up to ``STAGE_MAX_BYTES`` in shared memory; a larger one is read
    from global memory."""
    return nbytes <= STAGE_MAX_BYTES


def check_aligned(**operands) -> None:
    """The two-level kernels read these operands in 16-byte loads."""
    for name, x in operands.items():
        _check_aligned(name, x, 16)


class BlasStatic(NamedTuple):
    """Per-mesh 128-leaf BLASes (``pack_blas``), built once per scene; the
    tensors on one device, the ranges host numpy."""

    blas_nodes: torch.Tensor  # (Mb, 8) f32, links BLAS-local values
    tri_tiles: torch.Tensor  # (Lt*16, 128) f32 object-space leaf tiles
    row_tri: torch.Tensor  # (Lt*128,) i32 global row -> mesh-local tri
    node_start: np.ndarray  # (num_meshes,) i32
    node_count: np.ndarray
    tile_base: np.ndarray


class TlasBuffers(NamedTuple):
    """K6's operands for one frame (see the module docstring)."""

    tlas_nodes: torch.Tensor  # (Mt, 8) f32: min3, max3, skip, inst | -1
    blas_nodes: torch.Tensor  # (Mb, 8) f32
    inst_table: torch.Tensor  # (I, 16) f32
    tri_tiles: torch.Tensor  # (Lt*16, 128) f32
    row_tri: torch.Tensor  # (Lt*128,) i32
    inst_tri_base: torch.Tensor  # (I,) i32 global shading-row base
    inst_mesh: torch.Tensor  # (I,) i32

    @property
    def num_tlas_nodes(self) -> int:
        return self.tlas_nodes.shape[0]

    @property
    def num_instances(self) -> int:
        return self.inst_table.shape[0]


def pack_blas(mesh_tris, device="cpu") -> BlasStatic:
    """Per-mesh BLAS builds with 128-triangle leaves in one tile space
    (traverse_tlas.py:97-130, ``pack_blas_pallas``)."""
    nodes_l, tiles_l, row_tri_l = [], [], []
    node_start, node_count, tile_base = [], [], []
    n_off = t_off = 0
    for v0, e1, e2 in mesh_tris:
        tb = build_threaded_bvh(v0, e1, e2, leaf_size=LEAF)
        nd = tb.nodes[:, 0:8].astype(np.float32).copy()
        skip = tb.nodes[:, 6].view(np.int32)
        leaf_row = tb.nodes[:, 7].view(np.int32)
        nd[:, 6] = skip.astype(np.float32)  # BLAS-local links as values
        nd[:, 7] = np.where(leaf_row >= 0, leaf_row // LEAF, -1).astype(
            np.float32)
        nodes_l.append(nd)
        rows = tb.tri_rows
        nl = rows.shape[0] // LEAF
        tiles = np.zeros((nl, 16, LEAF), np.float32)
        tiles[:, 0:9, :] = rows[:, 0:9].reshape(nl, LEAF, 9).transpose(0, 2, 1)
        tiles_l.append(tiles.reshape(nl * 16, LEAF))
        row_tri_l.append(tb.row_tri.astype(np.int32))
        node_start.append(n_off)
        node_count.append(nd.shape[0])
        tile_base.append(t_off)
        n_off += nd.shape[0]
        t_off += nl
    return BlasStatic(
        blas_nodes=_up(np.concatenate(nodes_l), device),
        tri_tiles=_up(np.concatenate(tiles_l), device),
        row_tri=_up(np.concatenate(row_tri_l), device),
        node_start=np.asarray(node_start, np.int32),
        node_count=np.asarray(node_count, np.int32),
        tile_base=np.asarray(tile_base, np.int32),
    )


def pack_two_level(static: BlasStatic, mesh_ids, tri_base, tlas_nodes,
                   tlas_row_inst, inst_inv, inst_cull_scale) -> TlasBuffers:
    """One frame's K6 operands (traverse_tlas.py:133-176,
    ``pack_two_level_pallas``): the TLAS of ``tlas.build_tlas_nodes`` with
    its links as float values and column 7 the instance id, and the
    instance table from the frame's inverse affines (``inst_inv``, (I, 12))
    and sigma_min scales, around the static BLAS tensors (the same
    objects, not copies). Host numpy in, tensors on the BLAS's device."""
    dev = static.blas_nodes.device
    mesh_ids = np.asarray(mesh_ids, np.int64)
    tn = np.asarray(tlas_nodes[:, 0:8], np.float32).copy()
    skip = np.asarray(tlas_nodes[:, 6]).view(np.int32)
    leaf_row = np.asarray(tlas_nodes[:, 7]).view(np.int32)
    row_inst = np.asarray(tlas_row_inst, np.int32)
    tn[:, 6] = skip.astype(np.float32)
    tn[:, 7] = np.where(leaf_row >= 0, row_inst[np.maximum(leaf_row, 0)],
                        -1).astype(np.float32)
    inv12 = np.asarray(inst_inv, np.float32)
    it = np.zeros((inv12.shape[0], 16), np.float32)
    it[:, 0:12] = inv12
    # sigma_min(A), not cbrt|det A|: the reference's packet cull scales
    # object distances by it (kept for the layout; the per-ray walk here
    # needs no cull scale)
    it[:, 12] = np.asarray(inst_cull_scale, np.float32)
    it[:, 13] = static.node_start.astype(np.float32)[mesh_ids]
    it[:, 14] = static.node_count.astype(np.float32)[mesh_ids]
    it[:, 15] = static.tile_base.astype(np.float32)[mesh_ids]
    return TlasBuffers(
        tlas_nodes=_up(tn, dev),
        blas_nodes=static.blas_nodes,
        inst_table=_up(it, dev),
        tri_tiles=static.tri_tiles,
        row_tri=static.row_tri,
        inst_tri_base=_up(np.asarray(tri_base, np.int32)[mesh_ids], dev),
        inst_mesh=_up(mesh_ids.astype(np.int32), dev),
    )


def blas_resident(bb: TlasBuffers, start: int, count: int,
                  tile_base: int) -> ResidentBVH:
    """One mesh's BLAS decoded to the resident layout of the plain walk:
    its ``count`` nodes from ``start`` with integer links (the last skip
    equals ``count``, so the walk leaves there) and its leaf tiles from
    ``tile_base`` as (L*128, 9) rows, whose index is the mesh-local row
    ``leaf*128 + k``."""
    nodes = bb.blas_nodes[start:start + count]
    leaves = int(nodes[:, 7].max().item()) + 1
    tiles = bb.tri_tiles.view(-1, 16, LEAF)[tile_base:tile_base + leaves, 0:9]
    rows = tiles.transpose(1, 2).reshape(leaves * LEAF, 9)
    return ResidentBVH(
        bounds=nodes[:, 0:6],
        links=nodes[:, 6:8].to(torch.int32),
        tri_rows=rows,
        row_tri=bb.row_tri[tile_base * LEAF:(tile_base + leaves) * LEAF],
        leaf_size=LEAF,
        real_rows=real_row_counts(rows, LEAF),
    )


def leaf_boxes(bb: TlasBuffers):
    """Per mesh (keyed by node_start), the object-space boxes (K, 6) of its
    BLAS's leaf nodes: the leaves K6's bound counts."""
    it = bb.inst_table.cpu().numpy()
    out = {}
    for start, count in {(int(r[13]), int(r[14])) for r in it}:
        nodes = bb.blas_nodes[start:start + count]
        out[start] = nodes[nodes[:, 7] >= 0, 0:6]
    return out


# ---------------------------------------------------------------------------
# Plain version of K6 and the kernel launch
# ---------------------------------------------------------------------------


def plain(bb: TlasBuffers, rays: torch.Tensor, any_hit: bool,
          ordered: bool = False):
    """The plain version of K6 on a packed (8, N) operand: what the
    wrappers run on CPU tensors, and what ``launch`` must equal on the
    card: ``tlas.sweep`` over the TLAS, each entered instance walking its
    mesh's BLAS (``blas_resident``) by the instance table's inverse affine;
    ``ordered`` (closest hits only) is ``plain_ordered``. Returns (t,
    global row, u, v, inst) or the blocked flags."""
    if ordered:
        assert not any_hit, "the ordered walk is a closest-hit strategy"
        return plain_ordered(bb, rays)
    top = bb.tlas_nodes.cpu().numpy().astype(np.int64)
    table = bb.inst_table.tolist()
    cache = {}

    def enter(iid):
        row = table[iid]
        key = (int(row[13]), int(row[14]), int(row[15]))
        if key not in cache:
            cache[key] = blas_resident(bb, *key)
        return cache[key], row, key[2] * LEAF, iid

    return sweep(bb.tlas_nodes[:, 0:6], top[:, 6], top[:, 7], rays, any_hit,
                 enter)


def plain_ordered(bb: TlasBuffers, rays: torch.Tensor):
    """The plain version of K6's ordered instance walk: ``tlas.ordered_sweep``
    over the TLAS, each round one batched plain walk in which every ray
    walks its own instance's BLAS (its node range, tile base and object
    ray from the instance table). Returns (t, global row, u, v, inst)."""
    nodes = bb.blas_nodes
    links = nodes[:, 6:8].to(torch.int32)
    rows = bb.tri_tiles.view(-1, 16, LEAF)[:, 0:9].transpose(1, 2).reshape(-1, 9)
    top = bb.tlas_nodes.cpu().numpy()

    def visit(ids, iid, t_cap):
        row = bb.inst_table[iid.long()]
        o, d = object_ray([row[:, k] for k in range(12)],
                          Vec3(*rays[0:3, ids]), Vec3(*rays[3:6, ids]))
        return traverse.walk_ranges(
            nodes[:, 0:6], links, rows, LEAF, o, d, rays[6, ids], t_cap, False,
            node0=row[:, 13].long(), count=row[:, 14].long(),
            row0=row[:, 15].long() * LEAF)

    return ordered_sweep(bb.tlas_nodes[:, 0:6], top[:, 7].astype(np.int64),
                         rays, visit)


def _lib():
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    lib = build.load(KERNEL)
    # every pointer and the stream as c_void_p (a bare Python int would be
    # passed as a 32-bit C int and cut the pointer)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rptr_traverse_tlas.argtypes = [p, i, p, p, p, p, i, i, i, i, i] + [p] * 7
    lib.rptr_traverse_tlas.restype = ctypes.c_int
    lib.rptr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rptr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_buffers(bb: TlasBuffers, dev) -> None:
    """Device, type, shape and contiguity of K6's operands."""
    _check("tlas_nodes", bb.tlas_nodes, torch.float32, (bb.num_tlas_nodes, 8), dev)
    _check("blas_nodes", bb.blas_nodes, torch.float32,
           (bb.blas_nodes.shape[0], 8), dev)
    _check("inst_table", bb.inst_table, torch.float32, (bb.num_instances, 16), dev)
    _check("tri_tiles", bb.tri_tiles, torch.float32,
           (bb.tri_tiles.shape[0], LEAF), dev)
    if bb.tri_tiles.shape[0] % 16:
        raise ValueError("tri_tiles: rows are not whole 16-row leaf tiles")
    check_aligned(tlas_nodes=bb.tlas_nodes, blas_nodes=bb.blas_nodes,
                  tri_tiles=bb.tri_tiles)


def tlas_bytes(bb: TlasBuffers) -> int:
    """The shared memory a block needs to stage the TLAS."""
    return bb.tlas_nodes.numel() * bb.tlas_nodes.element_size()


def launch(bb: TlasBuffers, rays: torch.Tensor, any_hit: bool,
           ordered: bool = False, staged: bool = None, threads: int = None):
    """One K6 launch over a packed (8, N) operand, one lane per ray;
    ``ordered``: the ordered instance walk (closest hits only). ``staged``:
    each block stages the TLAS in shared memory (True) or the kernel reads
    it from global memory (False); None picks by size (``top_staged``).
    ``threads`` per block (a multiple of 32 up to 512): ``THREADS`` by
    default. Returns the raw output tensors: (t, row, u, v, inst) or the
    blocked flags."""
    global launches_k6, launches_k6_ordered, launches_k6_global
    if ordered and any_hit:
        raise ValueError(f"{KERNEL}: the ordered walk is closest-hit only")
    dev = rays.device
    n = rays.shape[1]
    check_buffers(bb, dev)
    _check("rays", rays, torch.float32, (8, n), dev)
    if any_hit:
        blocked = torch.empty(n, dtype=torch.bool, device=dev)
        outs = (None,) * 5 + (blocked.data_ptr(),)
        result = blocked
    else:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        row = torch.empty(n, dtype=torch.int32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
        inst = torch.empty(n, dtype=torch.int32, device=dev)
        result = (t, row, u, v, inst)
        outs = tuple(x.data_ptr() for x in result) + (None,)
    if n == 0:
        return result
    lib = _lib()
    if staged is None:
        staged = top_staged(tlas_bytes(bb))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rptr_traverse_tlas(
            bb.tlas_nodes.data_ptr(), bb.num_tlas_nodes,
            bb.blas_nodes.data_ptr(), bb.inst_table.data_ptr(),
            bb.tri_tiles.data_ptr(), rays.data_ptr(), n, int(any_hit),
            int(ordered), int(not staged), threads or THREADS, *outs, stream,
        )
    if rc != 0:
        msg = lib.rptr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{KERNEL} launch failed: {msg} (cudaError {rc})")
    launches_k6 += 1
    launches_k6_ordered += int(ordered)
    launches_k6_global += int(not staged)
    return result


def traverse_rays(bb: TlasBuffers, rays: torch.Tensor, any_hit: bool,
                  ordered: bool = False):
    """K6 on a packed operand: ``plain`` on the CPU, the kernel on a card."""
    if rays.device.type == "cpu":
        return plain(bb, rays, any_hit, ordered)
    if rays.device.type == "cuda":
        return launch(bb, rays.contiguous(), any_hit, ordered)
    raise ValueError(f"no traversal for device {rays.device}")


def out_to_hit(bb: TlasBuffers, out, n: int) -> TwoLevelHit:
    """Kernel output (t, row, u, v, inst) -> TwoLevelHit of the first ``n``
    lanes, ``tri = inst_tri_base[inst] + row_tri[row]`` (traverse_tlas.py:
    551-560)."""
    t, row, u, v, inst = (x[:n] for x in out)
    miss = row < 0
    local = bb.row_tri[torch.clamp(row, min=0).long()]
    base = bb.inst_tri_base[torch.clamp(inst, min=0).long()]
    tri = torch.where(miss, -1, base + local).to(torch.int32)
    return TwoLevelHit(t=t, tri=tri, u=u, v=v, inst=torch.where(miss, -1, inst))


def closest_hit_tlas(bb: TlasBuffers, ro: Vec3, rd: Vec3, t_min=0.0,
                     t_max=T_MAX, block: int = DEFAULT_BLOCK,
                     ordered: bool = False) -> TwoLevelHit:
    """K6 closest hit with global shading rows and instance ids; ``ordered``
    visits each ray's instances nearest first."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    return out_to_hit(bb, traverse_rays(bb, rays, any_hit=False,
                                        ordered=ordered), n)


def occluded_tlas(bb: TlasBuffers, ro: Vec3, rd: Vec3, t_min=0.0,
                  t_max=T_MAX, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """K6 any-hit visibility: True where (t_min, t_max) is blocked."""
    rays, n = pack_rays(ro, rd, t_min, t_max, block)
    return traverse_rays(bb, rays, any_hit=True)[:n]
