"""Each leaf's real-row count, which K1, K2, K8a and K8b stop a leaf at.

The packs pad every leaf to its full size by repeating the leaf's last
triangle. ``traverse.real_row_counts`` finds, from the rows' bits, the least
count c such that rows [c, leaf size) all equal row c - 1; such rows can
never change a walk's result, so the kernels skip them and must still equal
their plain versions bit for bit. Held here on the CPU, on cornell,
terrain(30), terrain(40), the tie scene (whose rays meet equal-t triangles
in two leaves) and the 9,522-triangle grid, for ``pack_resident`` and
``pack_flat`` at leaf 32, 64 and 128 and for ``pack_v1``:

- each leaf's count equals the number of distinct source triangles in its
  ``row_tri``, so the skip takes exactly the padding;
- the plain walk ``walk_ranges`` over only the first count rows of each
  leaf (the rows past it replaced by zero rows, which no ray hits) equals
  the walk over every row bit for bit, closest and any-hit, on a primary
  and a bounce queue of each scene;
- K2's plain version (``traverse_flat.plain_flat``, whose kernel scans each
  held leaf up to its count) over only those rows equals it over every
  row, on the same queues, for ``pack_flat`` at leaf 32, 64 and 128.
"""

import functools
import sys

import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident as tr
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_v1 as tv
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_cuda import tie_world  # noqa: E402
from test_traverse_kernels import _terrain  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

N = 768  # rays per queue


def _flat(vkr):
    f = Scene.from_vkr_scene(vkr).flatten_world()
    return f.v0, f.e1, f.e2


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(v0, e1, e2) of a scene, numpy f32."""
    if name == "cornell":
        return _flat(procedural.cornell_box())
    if name.startswith("terrain"):
        return _flat(procedural.terrain(grid=int(name[7:])))
    if name == "tie":
        return tie_world()[0]
    return _terrain(70)  # "grid9522"


SCENES = ("cornell", "terrain30", "terrain40", "tie", "grid9522")
PACKS = ("resident32", "resident64", "resident128", "flat32", "flat64",
         "flat128", "v1")


@functools.lru_cache(maxsize=None)
def _pack(scene, pack):
    leaf = tv.LEAF if pack == "v1" else int(pack.removeprefix("resident")
                                              .removeprefix("flat"))
    tb = bvh_mod.build_threaded_bvh(*_scene(scene), leaf_size=leaf, builder="sah")
    if pack == "v1":
        return tv.pack_v1(tb)
    return (tr.pack_resident if pack.startswith("resident") else tf.pack_flat)(tb)


def _tables(b):
    """(bounds, links with leaf indices, (R, 9) rows, leaf size, row_tri)
    of a pack, as the plain walk reads them."""
    if isinstance(b, tv.V1BVH):
        lr = b.links[:, 1]
        links = torch.stack([b.links[:, 0], torch.where(lr >= 0, lr // tv.LEAF, -1)], 1)
        rows = b.tris[:, 0:9] if b.wide else b.tris[0:9].t()
        return b.bounds, links, rows.contiguous(), tv.LEAF, b.row_tri
    return b.bounds, b.links, b.tri_rows, b.leaf_size, b.row_tri


@functools.lru_cache(maxsize=None)
def _queues(scene):
    """Primary and bounce queues (ro, rd, tmin, tmax), numpy: the tie
    scene's own rays and their hit points' bounces; on the others rays from
    above the scene's box toward random points in it, then bounces from
    their hits with random directions (20% of the bounce lanes dead)."""
    rng = np.random.default_rng(11)
    v0, e1, e2 = _scene(scene)
    if scene == "tie":
        ro, rd, tmax, _ = tie_world()[1]
    else:
        lo, hi = v0.min(0), v0.max(0)
        span = np.maximum(hi - lo, 1e-3)
        ro = np.broadcast_to(((lo + hi) / 2 + [0.0, 1.5, 2.0] * span),
                             (N, 3)).astype(np.float32)
        if scene == "cornell":
            ro = np.broadcast_to(np.float32([0.0, 1.0, 3.2]), (N, 3)).copy()
        target = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
        rd = target - ro
        rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
        tmax = np.full(len(ro), 2.0e32, np.float32)
    ro, rd = np.ascontiguousarray(ro, np.float32), np.ascontiguousarray(rd, np.float32)
    b = _pack(scene, "resident32" if scene != "tie" else "resident128")
    bounds, links, rows, ls, _ = _tables(b)
    h = traverse.walk_ranges(bounds, links, rows, ls, _soa(ro), _soa(rd), 0.0,
                             torch.from_numpy(tmax), False)
    t = h.t.numpy()
    hit = t < 1e30
    p = (ro + rd * np.where(hit, t, 0.0)[:, None]).astype(np.float32)
    d = rng.normal(size=p.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = hit & (rng.uniform(size=len(p)) > 0.2)
    tmin_b = ((np.linalg.norm(p, axis=-1) + 1.0) * 1e-4).astype(np.float32)
    return ((ro, rd, np.zeros(len(ro), np.float32), tmax),
            (p, d, tmin_b, np.where(live, 2.0e32, 0.0).astype(np.float32)))


def _soa(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Vec3(*(t[:, k].contiguous() for k in range(3)))


@pytest.mark.parametrize("pack", PACKS)
@pytest.mark.parametrize("scene", SCENES)
def test_real_rows_are_the_distinct_triangles(scene, pack):
    """Each leaf's count is the number of distinct triangles in its
    ``row_tri`` (int32, one per leaf), so the rows past it are exactly the
    padding that repeats the leaf's last triangle."""
    b = _pack(scene, pack)
    _, _, rows, ls, row_tri = _tables(b)
    counts = b.real_rows
    assert counts.dtype == torch.int32 and counts.shape == (rows.shape[0] // ls,)
    distinct = torch.tensor([len(np.unique(x)) for x in
                             row_tri.numpy().reshape(-1, ls)], dtype=torch.int32)
    assert torch.equal(counts, distinct)
    # the padding repeats the last real row, bit for bit
    bits = rows.contiguous().view(torch.int32).reshape(-1, ls, 9)
    last = bits[torch.arange(bits.shape[0]), counts.long() - 1]
    pad = torch.arange(ls)[None, :] >= counts[:, None]
    assert torch.equal(bits[pad], last[:, None].expand(-1, ls, 9)[pad])
    if scene == "cornell":
        assert counts.tolist() == [32]


def _cut(rows, counts, ls):
    """The rows with every row past its leaf's count replaced by a zero row
    (det = 0: no ray hits it)."""
    pad = (torch.arange(ls)[None, :] >= counts[:, None]).reshape(-1)
    return torch.where(pad[:, None], 0.0, rows)


@pytest.mark.parametrize("pack", PACKS)
@pytest.mark.parametrize("scene", SCENES)
def test_walk_over_real_rows_equals_the_full_walk(scene, pack):
    """``walk_ranges`` over only the first count rows of each leaf equals
    the walk over every row bit for bit (t, row, u, v; any-hit flags), on a
    primary and a bounce queue (the tie scene's bounces meet nothing); at
    leaf 128 the counts skip padding on every scene."""
    b = _pack(scene, pack)
    bounds, links, rows, ls, _ = _tables(b)
    cut = _cut(rows, b.real_rows, ls)
    if ls == 128:
        assert not torch.equal(cut, rows)
    for q, (ro, rd, tmin, tmax) in enumerate(_queues(scene)):
        o, d = _soa(ro), _soa(rd)
        tmin, tmax = torch.from_numpy(tmin), torch.from_numpy(tmax)
        full = traverse.walk_ranges(bounds, links, rows, ls, o, d, tmin, tmax, False)
        real = traverse.walk_ranges(bounds, links, cut, ls, o, d, tmin, tmax, False)
        for a, c in zip(full, real):
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        # the tie scene's few triangles leave its bounce queue without a hit
        hits = q == 0 or scene != "tie"
        assert (full.tri >= 0).any() == hits
        # any-hit on segments just short of and past each closest hit
        scale = torch.where(torch.arange(len(ro)) % 2 == 0, 0.999, 1.001)
        otm = torch.where(full.tri >= 0, full.t * scale, tmax)
        blocked = traverse.walk_ranges(bounds, links, rows, ls, o, d, tmin, otm, True)
        assert torch.equal(blocked, traverse.walk_ranges(
            bounds, links, cut, ls, o, d, tmin, otm, True))
        assert blocked.any() == hits and not blocked.all()


FLAT_PACKS = ("flat32", "flat64", "flat128")


@pytest.mark.parametrize("pack", FLAT_PACKS)
@pytest.mark.parametrize("scene", SCENES)
def test_flat_cull_over_real_rows_equals_the_full_flush(scene, pack):
    """K2's function (each lane's own survivors of its 128-lane group's
    broad phase, ``plain_flat``) over only the first count rows of each
    leaf equals it over every row bit for bit, closest and any-hit, on a
    primary and a bounce queue of each scene, so the kernel's counted scan
    keeps its plain version's result."""
    b = _pack(scene, pack)
    cut = b._replace(tri_rows=_cut(b.tri_rows, b.real_rows, b.leaf_size))
    for ro, rd, tmin, tmax in _queues(scene):
        rays, _ = tr.pack_rays(_soa(ro), _soa(rd), torch.from_numpy(tmin),
                               torch.from_numpy(tmax), 128)
        full = tf.plain_flat(b, rays, False)
        for a, c in zip(full, tf.plain_flat(cut, rays, False)):
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        scale = torch.where(torch.arange(rays.shape[1]) % 2 == 0, 0.999, 1.001)
        orays = rays.clone()
        orays[7] = torch.where(full[1] >= 0, full[0] * scale, rays[7])
        blocked = tf.plain_flat(b, orays, True)
        assert torch.equal(blocked, tf.plain_flat(cut, orays, True))
        assert blocked.any() == bool((full[1] >= 0).any())
