"""The port's walks on rays with a zero direction component, against a
brute-force Möller-Trumbore and the JAX package's kernels.

Every walk of the port tests a node or leaf box with the per-ray slab test
of ``ops/intersect.py::slab_interval``: on an axis where the direction
component is exactly 0 the slab is the whole line when the origin lies
within it and empty otherwise (the products with 1e20 used to cap a ray on
a box's max face at t = 0, and the walk never tested that leaf). The queue
is ``tests/test_torch_flat_cull.py``'s axis-aligned one on
``_terrain(24)``: x = 0 directions from origins on leaf-box faces and
edges of the leaf-32/64/128 flat-cull pack.

- Every plain walk (K1, K2, K3, K4 and K5 on the streamed pack, K6 and K7
  on one instance of the terrain under the identity transform, and
  ``traverse_v1.plain_lanes``) against a brute-force Möller-Trumbore over
  every real triangle, in the walks' own expressions
  (``traverse._mt_rows``): t bitwise the brute force's least t, the
  triangle one of those that reach it, any-hit flags equal, on every lane
  but those whose least-t hit lies outside its leaf's box in float64 (f32
  Möller-Trumbore accepts a hit just past an edge there, so no slab test
  of that box need pass). Those lanes are counted; they are a handful at
  most.
- The lanes where the port's K1 and V1 walks differ from the reference's
  K1 (``closest_hit_pallas2`` / ``occluded_pallas2`` in interpret mode) are
  counted and printed, and each is an edge lane (``_edge_lanes``).
- K2's broad phase on this queue: its entry bound ``lb`` is a lower bound
  of every live lane's slab entry, and every leaf a lane enters survives.
- Models of the K2 and K3 kernels' leaf loops (K2: survivors sorted by
  entry bound, K3: leaves in index order; each lane's box test capped at
  its best t raised by 2^-20 of itself, ``csrc/flat_cull.cuh::leaf_cap``)
  equal the plain versions bitwise on this queue, where hits on a box's
  face lie an ulp before the box's f32 entry (capped at the best t alone,
  K2's model took a higher row on 4 exact-t ties at leaf 32).
"""

import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.ops import bvh as jbvh
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas2 as tp2
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas3 as tp3
from realtimepathtracingresearchframework_tpu_torch.ops import bvh as tbvh
from realtimepathtracingresearchframework_tpu_torch.ops import tlas
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_binned as tb
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident as tr
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_stream as ts
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas as tt
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas_stream as tts
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_v1 as tv1
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_flat_cull import _axis_rays, _edge_lanes, _sorted_walk  # noqa: E402
from test_traverse_kernels import _terrain  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

LEAVES = (32, 64, 128)
WALKS = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "v1")
# lanes of 1,024 whose least-t hit lies outside its leaf's box in float64
# (Möller-Trumbore rounding, the only lanes a walk may miss): at most this
# many per walk and leaf size
MAX_OUTSIDE = 32


@pytest.fixture(autouse=True)
def _interpret_kernels():
    tp2.INTERPRET = True
    tp3.INTERPRET = True
    yield
    tp2.INTERPRET = False
    tp3.INTERPRET = False


def _soa(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Vec3(*(t[:, k].contiguous() for k in range(3)))


@functools.lru_cache(maxsize=None)
def _tris():
    """The terrain's (T, 9) f32 rows [v0, e1, e2], source order."""
    return np.concatenate(_terrain(24), axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _queue(leaf_size):
    """The axis-aligned queue on the leaf-``leaf_size`` flat pack's boxes:
    (ro, rd) numpy, and any-hit segment ends just past each lane's
    brute-force least t (8.0 on a miss)."""
    tbt = tbvh.build_threaded_bvh(*_terrain(24), leaf_size=leaf_size)
    ro, rd = _axis_rays(tf.pack_flat(tbt), np.random.default_rng(0x5EED))
    t, _ = _brute(ro, rd)
    otm = np.where(t < 1e30, t * np.float32(1.001), 8.0).astype(np.float32)
    return ro, rd, otm


def _brute(ro, rd):
    """Möller-Trumbore of every lane against every triangle in the walks'
    expression order: (least t per lane, 2e32 on a miss; (N, T) mask of
    the triangles that reach it)."""
    rows = torch.from_numpy(_tris())[None]
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    ok, _, _, tt = traverse._mt_rows(rows, *(x[:, None] for x in (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])))
    tt = torch.where(ok & (tt > 0.0) & (tt < 2.0e32), tt, 2.0e32)
    least = tt.amin(1)
    return least.numpy(), ((tt == least[:, None]) & (least < 2.0e32)[:, None]).numpy()


def _boxes_of(bounds, leaf_of_node, ls, row_tri, boxes):
    """Add each triangle's leaf box to ``boxes`` (tri -> list of (6,)):
    node i with leaf id ``leaf_of_node[i] >= 0`` owns rows leaf * ls + k,
    whose source triangles are ``row_tri`` (numpy, -1 or past its end:
    none)."""
    bounds = np.asarray(bounds, np.float64)
    for i in np.nonzero(np.asarray(leaf_of_node) >= 0)[0]:
        leaf = int(leaf_of_node[i])
        for tri in np.asarray(row_tri)[leaf * ls:(leaf + 1) * ls]:
            if tri >= 0:
                boxes.setdefault(int(tri), []).append(bounds[i])
    return boxes


@functools.lru_cache(maxsize=None)
def _structures(leaf_size):
    """Every walk's structure over the terrain and each source triangle's
    leaf boxes in it: {walk: (structure, tri -> [box])}."""
    v0, e1, e2 = _terrain(24)
    out = {}
    tbt = tbvh.build_threaded_bvh(v0, e1, e2, leaf_size=leaf_size)
    fb = tf.pack_flat(tbt)
    res = _boxes_of(fb.bounds.numpy(), fb.links[:, 1].numpy(), leaf_size,
                    fb.row_tri.numpy(), {})
    for k in ("k1", "k2", "k3"):
        out[k] = (fb, res)
    v1 = tv1.pack_v1(tbvh.build_threaded_bvh(v0, e1, e2, leaf_size=tv1.LEAF))
    lr = v1.links[:, 1].numpy()
    out["v1"] = (v1, _boxes_of(v1.bounds.numpy(), np.where(lr >= 0, lr // tv1.LEAF, -1),
                               tv1.LEAF, v1.row_tri.numpy(), {}))
    sb = ts.pack_streamed(v0, e1, e2)
    boxes = {}
    for s in range(sb.num_subtrees):
        sub = ts.subtree_resident(sb, s)
        nodes = sub.bounds.numpy()
        links = sub.links.numpy()
        leaf = np.where((links[:, 1] >= 0) & (links[:, 0] > 0), links[:, 1], -1)
        _boxes_of(nodes, leaf, ts.LEAF, sub.row_tri.numpy(), boxes)
    out["k4"] = out["k5"] = (sb, boxes)
    meshes = [(v0, e1, e2)]
    mesh_ids = np.zeros(1, np.int32)
    xfs = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None].astype(np.float32)
    blas = tlas.build_blas_set(meshes)
    nodes, row = tlas.build_tlas_nodes(tlas.instance_world_aabbs(blas, mesh_ids, xfs))
    tables = tlas.build_instance_tables(blas, mesh_ids, np.zeros(1, np.int32), xfs)
    st6 = tt.pack_blas(meshes)
    bb6 = tt.pack_two_level(st6, mesh_ids, blas.tri_base, nodes, row,
                            tables["inst_inv"].numpy(),
                            tables["inst_cull_scale"].numpy())
    start, count, tile = (int(x) for x in bb6.inst_table[0, 13:16].tolist())
    blas0 = tt.blas_resident(bb6, start, count, tile)
    out["k6"] = (bb6, _boxes_of(blas0.bounds.numpy(), blas0.links[:, 1].numpy(),
                                tt.LEAF, blas0.row_tri.numpy(), {}))
    st7 = tts.pack_tlas_stream_static(meshes)
    fr = tts.pack_tlas_stream_frame(st7, mesh_ids, xfs, blas.tri_base)
    boxes = {}
    for c in range(st7.num_chunks):
        ch = tts.chunk_resident(st7, int(st7.chunk_node_base[c]),
                                int(st7.chunk_tile_base[c]))
        links = ch.links.numpy()
        leaf = np.where((links[:, 1] >= 0) & (links[:, 0] > 0), links[:, 1], -1)
        rt = st7.chunk_rowtri[c * st7.chunk_tris:(c + 1) * st7.chunk_tris].numpy()
        _boxes_of(ch.bounds.numpy(), leaf, tts.LEAF, rt, boxes)
    out["k7"] = ((st7, fr), boxes)
    return out


def _walk(name, st, o, d, tmax, any_hit):
    """One plain walk of the port: (t, source triangle) or blocked flags."""
    if name in ("k1", "k2", "k3"):
        fn = {"k1": (tr.closest_hit_resident, tr.occluded_resident),
              "k2": (tf.closest_hit_flat, tf.occluded_flat),
              "k3": (tf.closest_hit_precull, tf.occluded_precull)}[name]
        if any_hit:
            return fn[1](st, o, d, 0.0, tmax)
        h = traverse.map_rows_to_tris(st, fn[0](st, o, d, 0.0, tmax))
    elif name == "v1":
        if any_hit:
            return tv1.occluded_v1(st, o, d, 0.0, tmax)
        h = tv1.closest_hit_v1(st, o, d, 0.0, tmax, map_tri=True)
    elif name == "k4":
        if any_hit:
            return ts.occluded_streamed(st, o, d, 0.0, tmax)
        h = ts.closest_hit_streamed(st, o, d, 0.0, tmax, sort=True)
    elif name == "k5":
        if any_hit:
            return tb.occluded_binned(st, o, d, 0.0, tmax, rounds=1)
        h = tb.closest_hit_binned(st, o, d, 0.0, tmax)
    elif name == "k6":
        if any_hit:
            return tt.occluded_tlas(st, o, d, 0.0, tmax)
        h = tt.closest_hit_tlas(st, o, d, 0.0, tmax)
    else:
        if any_hit:
            return tts.occluded_tlas_stream(*st, o, d, 0.0, tmax)
        h = tts.closest_hit_tlas_stream(*st, o, d, 0.0, tmax)
    return h.t, h.tri


def _outside(ro, rd, least, ties, boxes):
    """(N,) bool: the lane's least-t hit (each triangle that reaches it)
    lies outside every leaf box that holds its triangle, the point taken in
    float64 from the f32 inputs."""
    tris = _tris().astype(np.float64)
    out = np.zeros(len(ro), bool)
    for i in np.nonzero(least < 1e30)[0]:
        o, d = ro[i].astype(np.float64), rd[i].astype(np.float64)
        inside = False
        for tri in np.nonzero(ties[i])[0]:
            v0, e1, e2 = tris[tri, 0:3], tris[tri, 3:6], tris[tri, 6:9]
            q = np.cross(o - v0, e1)
            t = (e2 @ q) / (e1 @ np.cross(d, e2))
            p = o + t * d
            inside |= any(bool((b[0:3] <= p).all() and (p <= b[3:6]).all())
                          for b in boxes[int(tri)])
        out[i] = not inside
    return out


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("leaf_size", LEAVES)
def test_walks_equal_brute_force_mt(leaf_size, walk):
    """Every plain walk against a brute-force Möller-Trumbore over every
    real triangle on the axis-aligned queue: t bitwise the least t, the
    triangle one of those that reach it, any-hit flags on segments just
    past it equal, except on the lanes whose least-t hit lies outside its
    leaf's box in float64 (at most ``MAX_OUTSIDE``, printed)."""
    ro, rd, otm = _queue(leaf_size)
    least, ties = _brute(ro, rd)
    st, boxes = _structures(leaf_size)[walk]
    o, d = _soa(ro), _soa(rd)
    t, tri = _walk(walk, st, o, d, 2.0e32, False)
    t, tri = t.numpy(), tri.numpy()
    blocked = _walk(walk, st, o, d, torch.from_numpy(otm), True).numpy()
    out = _outside(ro, rd, least, ties, boxes)
    assert out.sum() <= MAX_OUTSIDE
    keep = ~out
    assert (least < 1e30).mean() > 0.5 and keep.sum() > len(ro) - MAX_OUTSIDE
    np.testing.assert_array_equal(t.view(np.int32)[keep],
                                  least.view(np.int32)[keep])
    hit = keep & (least < 1e30)
    assert ties[np.nonzero(hit)[0], tri[hit]].all()
    assert (tri[keep & (least >= 1e30)] == -1).all()
    np.testing.assert_array_equal(blocked[keep], (least < 1e30)[keep])
    print(f"leaf {leaf_size} {walk}: {int(out.sum())} of {len(ro)} lanes hit "
          f"outside their leaf's box in float64")


@pytest.mark.parametrize("walk", ["k1", "v1"])
@pytest.mark.parametrize("leaf_size", LEAVES)
def test_lanes_off_the_reference_k1_are_edge_lanes(leaf_size, walk):
    """The port's K1 (and its V1 walk, each ray's own walk of the leaf-128
    tree) against the reference's K1 in interpret mode on the axis-aligned
    queue: the lanes whose triangle or any-hit flag differs are counted
    and printed (ROADMAP queue 3 records them), and each is an edge lane,
    whose hit on either side lies exactly on an edge of its triangle."""
    ro, rd, otm = _queue(leaf_size)
    tbt = jbvh.build_threaded_bvh(*_terrain(24), leaf_size=leaf_size)
    bb = tp2.pack_for_pallas2(tbt)
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)
    ref = np.asarray(tp2.closest_hit_pallas2(bb, jro, jrd, t_max=2.0e32).tri)
    flag = np.asarray(tp2.occluded_pallas2(bb, jro, jrd, t_max=jnp.asarray(otm)))
    st, _ = _structures(leaf_size)[walk]
    o, d = _soa(ro), _soa(rd)
    port = _walk(walk, st, o, d, 2.0e32, False)[1].numpy()
    blocked = _walk(walk, st, o, d, torch.from_numpy(otm), True).numpy()
    lanes = np.nonzero(port != ref)[0]
    olanes = np.nonzero(blocked != flag)[0]
    assert all(_edge_lanes(ro, rd, torch.from_numpy(lanes), port, ref))
    assert set(olanes.tolist()) <= set(lanes.tolist())
    assert lanes.size < 0.25 * len(ro)
    print(f"leaf {leaf_size} {walk}: {lanes.size} closest and {olanes.size} "
          f"any-hit lanes of {len(ro)} differ from the reference's K1, "
          "every one an edge lane")


@pytest.mark.parametrize("q", [32, 64, 128])
@pytest.mark.parametrize("leaf_size", LEAVES)
def test_entry_bound_holds_on_the_axis_aligned_queue(leaf_size, q):
    """K2's broad phase on the axis-aligned queue (every lane's direction
    has x = 0, so every group skips that axis): lb is at most every live
    lane's slab entry on every surviving leaf, every leaf a lane's slab
    test enters survives."""
    ro, rd, otm = _queue(leaf_size)
    st, _ = _structures(leaf_size)["k2"]
    for tmax in (2.0e32, torch.from_numpy(otm)):
        rays, _ = tr.pack_rays(_soa(ro), _soa(rd), 0.0, tmax, 128)
        keep, lb = tf.flat_leaf_bounds(rays, st.aabbs, q)
        tn, _ = tf.slab_entry(rays, st.aabbs)
        live = (rays[7] > rays[6])[:, None]
        lane_keep = keep.repeat_interleave(q, 0) & live
        assert lane_keep.any()
        assert (lb.repeat_interleave(q, 0)[lane_keep] <= tn[lane_keep]).all()
        assert not (tf.ray_leaf_hits(rays, st.aabbs) & ~lane_keep).any()


def _index_walk(fb, rays, any_hit):
    """A model of K3's leaf loop: every lane steps through the leaves in
    index order, testing a leaf whose box its slab test on [tmin, best t +
    |best t| x 2^-20] enters, and takes the leaf's first least hit when it
    is strictly nearer than its best (or, any-hit, stops at a hit)."""
    ls = fb.leaf_size
    n = rays.shape[1]
    t_best = rays[7].clone()
    row = torch.full((n,), -1, dtype=torch.int64)
    blocked = torch.zeros(n, dtype=torch.bool)
    live = rays[7] > rays[6]
    for leaf in range(fb.num_leaves):
        seg = rays.clone()
        seg[7] = t_best + t_best.abs() * 2.0 ** -20
        tn, tf_ = tf.slab_entry(seg, fb.aabbs[:, leaf:leaf + 1])
        holds = live & ~blocked & (tn[:, 0] <= tf_[:, 0])
        rows = fb.tri_rows[leaf * ls:(leaf + 1) * ls]
        ok, _, _, tt = traverse._mt_rows(rows[None],
                                         *(rays[k][:, None] for k in range(6)))
        hit = ok & (tt > rays[6][:, None]) & (tt < t_best[:, None])
        if any_hit:
            blocked |= holds & hit.any(1)
            continue
        tt = torch.where(hit, tt, float("inf"))
        t_leaf = tt.amin(1)
        k = torch.where(tt <= t_leaf[:, None], torch.arange(ls), ls).amin(1)
        take = holds & torch.isfinite(t_leaf)
        t_best = torch.where(take, t_leaf, t_best)
        row = torch.where(take, leaf * ls + k, row)
    if any_hit:
        return blocked
    return torch.where(row < 0, 2.0e32, t_best), row.to(torch.int32)


@pytest.mark.parametrize("leaf_size", LEAVES)
def test_kernel_leaf_loops_on_the_axis_aligned_queue(leaf_size):
    """The models of K2's sorted leaf loop and K3's index-order one equal
    the plain versions bitwise on the axis-aligned queue, closest and
    any-hit."""
    ro, rd, otm = _queue(leaf_size)
    st, _ = _structures(leaf_size)["k2"]
    for tmax, any_hit in ((2.0e32, False), (torch.from_numpy(otm), True)):
        rays, _ = tr.pack_rays(_soa(ro), _soa(rd), 0.0, tmax, 128)
        k2, k3 = tf.plain_flat(st, rays, any_hit), tf.plain_precull(st, rays, any_hit)
        m2 = _sorted_walk(st, rays, tf.CULL, any_hit)
        m3 = _index_walk(st, rays, any_hit)
        if any_hit:
            assert torch.equal(m2, k2) and torch.equal(m3, k3)
            continue
        for model, plain in ((m2, k2), (m3, k3)):
            assert torch.equal(model[0].view(torch.int32), plain[0].view(torch.int32))
            assert torch.equal(model[1], plain[1])
