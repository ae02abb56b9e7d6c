"""The port's streamed route (K4, K5) against the JAX package's.

- **Pack.** ``traverse_stream.pack_streamed`` equals the reference's bit
  for bit (top tree, subtree nodes, leaf tiles, ``row_tri``, topology) on
  ``procedural.terrain(32)`` and ``(48)`` and on the offset-copies scene of
  tests/test_traverse_kernels.py:236-243; ``pick_chunk_tris`` too.
- **Plain K4** (``traverse_stream.plain``, what the wrappers run on CPU
  tensors) against ``closest_hit_streamed`` / ``occluded_streamed`` in
  Pallas interpret mode: triangles and blocked flags exact; t within 1e-5
  relative and u, v within 1e-4 absolute, because XLA contracts some of
  Möller-Trumbore's multiply-adds into FMAs and the port does not (as for
  K1-K3; see ``_assert_hit_close``). Against the port's plain K1 on a leaf-128 resident BVH of the
  same triangles: triangles equal and t bitwise where they agree, as
  tests/test_traverse_kernels.py's streamed-vs-resident test asks.
- **K5's binning** (``subtree_bounds``, ``_entry_table``, ``_next_subtree``,
  ``_bin_layout``, the streamed coherence key and order) bit for bit
  against the reference; **plain K5** against ``occluded_binned`` (rounds 0
  and 1) and ``closest_hit_binned`` (2 rounds) in interpret mode and
  against plain K1: flags exact, triangles exact except on exact-t ties,
  which are counted, with the tied t equal.
- **Quantized tiles, the ordered walk, multislot.** The 16-bit quantized
  pack (``pack_streamed(quantize=True)``) and ``reconstruct_quantized``
  equal the reference's bit for bit; plain K4 and K5 on int16 tiles, K4's
  ordered walk and the multislot dispatch (``closest_hit_binned_all``,
  k_max 1 and 8, and with negative t) against the reference in interpret
  mode at the tolerances above, and against the port's own preorder walk
  (t bitwise, triangles except on exact-t ties, which are counted).
- **Integrator and frame.** The four ``stream_closest`` strategies
  (sorted, ordered, binned, multislot) pick the same triangles; ``procedural.terrain(48)`` forced onto the streamed
  route (``RPTR_FORCE_STREAMED_TRAVERSAL=1``) renders at 32x32, depth 5,
  two frames, with ray counts, first-hit triangles and the image equal
  bitwise to the port's own K1 route (same triangles, same t/u/v, same
  attributes); against the JAX renderer on the CPU (XLA traversal) ray
  counts and first-hit triangles exact, radiance at
  ``goldens.compare_ref``'s gate.

The JAX interpret oracles run once per function, in module fixtures, at
512 rays on ``terrain(48)`` (5 subtrees of 1,024 triangles). The CUDA
kernels are compared with these plain versions bitwise on the card by
``chip_smoke.py`` and tests/test_torch_cuda.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams as JaxRenderParams,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu.ops import traverse_binned as jtb
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas as tp1
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas2 as tp2
from realtimepathtracingresearchframework_tpu.ops import traverse_stream as jts
from realtimepathtracingresearchframework_tpu.ops.traverse import (
    closest_hit_threaded,
)
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_binned as tb
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident as tr
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_stream as ts
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3
from realtimepathtracingresearchframework_tpu_torch.profile_frame import frame_setup

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_cuda import k5_edge_operand  # noqa: E402
from test_traverse_kernels import _terrain  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

N_RAYS = 512
SIZE, DEPTH, GRID, FRAMES = 32, 5, 48, 2
ROUTE_ENV = ("RPTR_FORCE_STREAMED_TRAVERSAL", "RPTR_STREAM_CLOSEST",
             "RPTR_TRAVERSAL_V3", "RPTR_HOST_WAVEFRONT", "RPTR_COMPACT_LANES",
             "RPTR_COMPACT", "RPTR_KERNEL_V4", "RPTR_TRAVERSAL_V1")


class _env:
    """Set the route's environment for a block, restoring it after."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.pop(k, None) for k in ROUTE_ENV}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k in ROUTE_ENV:
            os.environ.pop(k, None)
            if self.old[k] is not None:
                os.environ[k] = self.old[k]


def _flat(grid):
    f = Scene.from_vkr_scene(procedural.terrain(grid=grid)).flatten_world()
    return f.v0, f.e1, f.e2


def _copies():
    """Nine offset copies of _terrain(32) (test_traverse_kernels.py:236-243)."""
    v0, e1, e2 = _terrain(32)
    copies = [v0 + np.array([9.0 * i, 0.0, 0.3 * i], np.float32)
              for i in range(9)]
    return np.concatenate(copies), np.concatenate([e1] * 9), np.concatenate([e2] * 9)


def _soa(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(), t[:, 2].contiguous())


def _queue(seed=3):
    """(ro, rd, tmax) of N_RAYS rays over terrain(48) (extent 20): half a
    camera fan from the bench camera, half incoherent rays from above the
    surface; 10% dead lanes (tmax = 0)."""
    rng = np.random.default_rng(seed)
    h = N_RAYS // 2
    side = int(np.sqrt(h))
    u = np.linspace(-1.0, 1.0, side, dtype=np.float32)
    uu, vv = np.meshgrid(u, u)
    d = np.stack([uu.ravel(), -0.4 + 0.3 * vv.ravel(),
                  -np.ones(side * side, np.float32)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro_c = np.broadcast_to(np.array([0.0, 5.0, 12.0], np.float32), d.shape)
    ro_i = rng.uniform(-10, 10, (N_RAYS - h, 3)).astype(np.float32)
    ro_i[:, 1] = rng.uniform(0.5, 3.0, N_RAYS - h)
    rd_i = rng.normal(size=(N_RAYS - h, 3)).astype(np.float32)
    rd_i /= np.linalg.norm(rd_i, axis=-1, keepdims=True)
    ro = np.concatenate([ro_c, ro_i]).astype(np.float32)
    rd = np.concatenate([d, rd_i]).astype(np.float32)
    tmax = np.where(rng.uniform(size=N_RAYS) < 0.1, 0.0, 2.0e32)
    return ro, rd, tmax.astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """terrain(48): the JAX pack, the port's pack, the port's resident
    leaf-128 BVH of the same triangles, and the queue with its any-hit
    segments (just short of / past each K1 hit)."""
    v0, e1, e2 = _flat(GRID)
    jb = jts.pack_streamed(v0, e1, e2)
    pb = ts.pack_streamed(v0, e1, e2)
    fb = tr.pack_resident(bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=128,
                                                     builder="sah"))
    ro, rd, tmax = _queue()
    o, d = _soa(ro), _soa(rd)
    k1 = traverse.map_rows_to_tris(
        fb, tr.closest_hit_resident(fb, o, d, 0.0, torch.from_numpy(tmax)))
    rng = np.random.default_rng(4)
    scale = np.where(rng.uniform(size=N_RAYS) < 0.5, 0.999, 1.001)
    otm = np.where(k1.tri.numpy() >= 0, k1.t.numpy() * scale, 30.0)
    otm = np.where(tmax > 0, otm, 0.0).astype(np.float32)
    return dict(jb=jb, pb=pb, fb=fb, ro=ro, rd=rd, tmax=tmax, otm=otm, k1=k1)


def _jax_comps(ro, rd):
    return tuple(jnp.asarray(np.ascontiguousarray(a[:, k]))
                 for a in (ro, rd) for k in range(3))


@pytest.fixture(scope="module")
def oracles(scene):
    """One interpret-mode call of each reference function on the queue."""
    jts.INTERPRET = tp2.INTERPRET = jtb.INTERPRET = True
    try:
        jb, ro, rd = scene["jb"], scene["ro"], scene["rd"]
        comps = _jax_comps(ro, rd)
        tm, otm = jnp.asarray(scene["tmax"]), jnp.asarray(scene["otm"])
        return dict(
            k4_closest=jts.closest_hit_streamed(jb, None, None, t_max=tm,
                                                comps=comps, sort=True),
            k4_occluded=jts.occluded_streamed(jb, None, None, t_max=otm,
                                              comps=comps),
            k5_occluded_0=jtb.occluded_binned(jb, None, None, t_max=otm,
                                              comps=comps, rounds=0),
            k5_occluded_1=jtb.occluded_binned(jb, None, None, t_max=otm,
                                              comps=comps, rounds=1),
            k5_closest=jtb.closest_hit_binned(jb, None, None, t_max=tm,
                                              comps=comps, rounds=2),
        )
    finally:
        jts.INTERPRET = tp2.INTERPRET = jtb.INTERPRET = False


def _assert_hit_close(hit, ref):
    """Triangles exact; t within 1e-5 relative; u and v within 1e-4
    absolute: XLA contracts the barycentric dot products into FMAs, and
    where their terms cancel, one rounding of a term of size |p||tvec|
    moves u by that times 6e-8 / |det| (measured: at most 1.3e-5 on this
    queue, one lane in 512 above 1e-5)."""
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=0)
    for p, r in ((hit.u, ref.u), (hit.v, ref.v)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def _ties(label, t_a, tri_a, t_b, tri_b):
    """Triangles equal except on exact-t ties; t bitwise equal everywhere.
    Returns the tie count."""
    assert torch.equal(t_a, t_b), label
    return int((tri_a != tri_b).sum())


# ---------------------------------------------------------------------------
# Pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["terrain32", "terrain48", "copies"])
def test_pack_matches_reference(name):
    v0, e1, e2 = _copies() if name == "copies" else _flat(int(name[7:]))
    jb, jtopo = jts.pack_streamed(v0, e1, e2, with_topology=True)
    pb, topo = ts.pack_streamed(v0, e1, e2, with_topology=True)
    for field in ("top_nodes", "sub_nodes", "tri_tiles", "row_tri"):
        a, b = getattr(pb, field).numpy(), np.asarray(getattr(jb, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert pb.sub_leaves == jb.sub_leaves
    assert pb.num_subtrees == jb.num_subtrees >= 2
    assert pb.num_top_nodes == 2 * pb.num_subtrees - 1
    for field in jtopo._fields:
        np.testing.assert_array_equal(np.asarray(getattr(topo, field)),
                                      np.asarray(getattr(jtopo, field)))
    # the 16-bit quantized pack, bit for bit, and its reconstruction
    jq = jts.pack_streamed(v0, e1, e2, quantize=True)
    pq = ts.pack_streamed(v0, e1, e2, quantize=True)
    assert pq.quantized and pq.tri_tiles.dtype == torch.int16
    for field in ("top_nodes", "sub_nodes", "tri_tiles", "row_tri"):
        a, b = getattr(pq, field).numpy(), np.asarray(getattr(jq, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    for a, b in zip(ts.reconstruct_quantized(v0, e1, e2),
                    jts.reconstruct_quantized(v0, e1, e2)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    with pytest.raises(ValueError, match="f32 tiles"):
        ts.pack_streamed(v0, e1, e2, quantize=True, with_topology=True)


def test_pick_chunk_tris():
    for n in (1, 1000, 4608, 65_536, 80_000, 90_001, 500_000, 524_288,
              600_000, 5_000_000):
        assert ts.pick_chunk_tris(n) == jts.pick_chunk_tris(n), n
        assert ts.node_rows_for(ts.pick_chunk_tris(n) // 128) == jts.node_rows_for(
            jts.pick_chunk_tris(n) // 128)
    assert ts.pick_chunk_tris(500_000) == 7936


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def test_plain_k4_matches_reference_and_k1(scene, oracles):
    """Plain K4, sorted and unsorted, closest and any-hit, against the
    reference kernel in interpret mode and against plain K1."""
    pb, fb, k1 = scene["pb"], scene["fb"], scene["k1"]
    o, d = _soa(scene["ro"]), _soa(scene["rd"])
    tm, otm = torch.from_numpy(scene["tmax"]), torch.from_numpy(scene["otm"])
    hits = [ts.closest_hit_streamed(pb, o, d, 0.0, tm, sort=s) for s in (False, True)]
    for x, y in zip(*hits):
        assert torch.equal(x, y)  # the sort is invisible in the result
    _assert_hit_close(hits[0], oracles["k4_closest"])
    assert 0.3 < (hits[0].tri >= 0).float().mean() < 0.95
    assert _ties("K4 vs K1", hits[0].t, hits[0].tri, k1.t, k1.tri) == 0
    blocked = [ts.occluded_streamed(pb, o, d, 0.0, otm, sort=s) for s in (False, True)]
    assert torch.equal(blocked[0], blocked[1])
    np.testing.assert_array_equal(blocked[0].numpy(), np.asarray(oracles["k4_occluded"]))
    assert torch.equal(blocked[0], tr.occluded_resident(fb, o, d, 0.0, otm))
    assert blocked[0].any() and not blocked[0].all()
    # rows: global rows map to the same triangles
    rows = ts.closest_hit_streamed(pb, o, d, 0.0, tm, map_tri=False)
    assert torch.equal(ts._out_to_hit(pb, tuple(rows), N_RAYS, True).tri,
                       hits[0].tri)


def test_k4_dead_and_pad_lanes_miss(scene):
    pb = scene["pb"]
    o, d = _soa(scene["ro"][:300]), _soa(scene["rd"][:300])
    hit = ts.closest_hit_streamed(pb, o, d, 1.0, 1.0)
    assert hit.t.shape == (300,)
    assert (hit.tri == -1).all() and (hit.t == 2.0e32).all()
    assert (hit.u == 0).all() and (hit.v == 0).all()
    assert not ts.occluded_streamed(pb, o, d, 2.0, 0.0).any()
    assert not tb.occluded_binned(pb, o, d, 2.0, 0.0).any()
    assert (tb.closest_hit_binned(pb, o, d, 1.0, 1.0).tri == -1).all()


def test_subtree_decode_and_leaf_boxes(scene):
    """The plain version's resident decode of a subtree, and the leaf
    boxes of the bound: one per leaf node, tight around its triangles."""
    pb = scene["pb"]
    slots = pb.sub_node_rows * 16
    total = 0
    for s in range(pb.num_subtrees):
        sub = ts.subtree_resident(pb, s)
        assert sub.bounds.shape == (slots, 6) and sub.links.dtype == torch.int32
        leaves = sub.links[:, 1][(sub.links[:, 1] >= 0) & (sub.links[:, 0] > 0)]
        total += leaves.numel()
        assert torch.equal(torch.sort(leaves).values, torch.arange(leaves.numel(),
                                                                  dtype=torch.int32))
    boxes, sid = ts.leaf_boxes(pb)
    assert int((sid >= 0).sum()) == total
    assert boxes.shape[1] % 128 == 0
    assert (boxes[0:3, :total] <= boxes[3:6, :total]).all()
    assert torch.equal(torch.unique(sid[:total]), torch.arange(pb.num_subtrees))


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def test_binning_matches_reference(scene):
    """subtree_bounds, _entry_table, _next_subtree over three rounds,
    _bin_layout, the streamed coherence key and order, bit for bit."""
    jb, pb = scene["jb"], scene["pb"]
    o, d = _soa(scene["ro"]), _soa(scene["rd"])
    rays, n = tr.pack_rays(o, d, 0.0, torch.from_numpy(scene["tmax"]), 512)
    jrays, jn = tp1._prep_rays(jnp.asarray(scene["ro"]), jnp.asarray(scene["rd"]),
                               0.0, jnp.asarray(scene["tmax"]), 512)
    assert n == jn
    np.testing.assert_array_equal(rays.numpy(), np.asarray(jrays))
    sb, jsb = tb.subtree_bounds(pb), jtb.subtree_bounds(jb)
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))
    key = ts._coherence_key(pb, tuple(rays[0:6]))
    jkey = jts._coherence_key(jb, tuple(jrays[k] for k in range(6)))
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey).astype(np.int64))
    dead = ~(rays[7] > rays[6])
    perm, inv = ts.coherence_order(key, dead)
    jperm, jinv = jts.coherence_order(jkey, jnp.asarray(dead.numpy()))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    srt, _ = tb._coherence_perm(pb, rays)
    jsrt, _ = jtb._coherence_perm(jb, jrays)
    np.testing.assert_array_equal(srt.numpy(), np.asarray(jsrt))

    entry, jentry = tb._entry_table(sb, srt), jtb._entry_table(jsb, jsrt)
    np.testing.assert_array_equal(entry.numpy(), np.asarray(jentry))
    assert (entry < 1e32).any()
    s = sb.shape[0]
    n_pad = tb.padded_lanes(n, s, 512)
    last_e = torch.full((n,), -2.0e32)
    last_s = torch.full((n,), -1, dtype=torch.int32)
    cap = srt[7].clone()
    seen = set()
    for _ in range(3):
        sid, mt = tb._next_subtree(entry, last_e, last_s, cap)
        jsid, jmt = jtb._next_subtree(jentry, jnp.asarray(last_e.numpy()),
                                      jnp.asarray(last_s.numpy()),
                                      jnp.asarray(cap.numpy()))
        np.testing.assert_array_equal(sid.numpy(), np.asarray(jsid))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(jmt))
        out = tb._bin_layout(sid, s, 512, n_pad)
        jout = jtb._bin_layout(jsid, s, 512, n_pad)
        for a, b, name in zip(out, jout, ("perm", "spos", "valid", "pos", "sid_blk")):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        seen.update(sid.tolist())
        last_e = torch.where(sid >= 0, mt, 2.0e32)
        last_s = torch.where(sid >= 0, sid, last_s)
    assert len(seen - {-1}) >= 3  # the rounds bin several subtrees


def test_plain_k5_matches_reference_and_k1(scene, oracles):
    pb, fb, k1 = scene["pb"], scene["fb"], scene["k1"]
    o, d = _soa(scene["ro"]), _soa(scene["rd"])
    tm, otm = torch.from_numpy(scene["tmax"]), torch.from_numpy(scene["otm"])
    b1 = tr.occluded_resident(fb, o, d, 0.0, otm)
    for rounds in (0, 1):
        blocked = tb.occluded_binned(pb, o, d, 0.0, otm, rounds=rounds)
        np.testing.assert_array_equal(
            blocked.numpy(), np.asarray(oracles[f"k5_occluded_{rounds}"]))
        assert torch.equal(blocked, b1)
    hit = tb.closest_hit_binned(pb, o, d, 0.0, tm, rounds=2)
    _assert_hit_close(hit, oracles["k5_closest"])
    ties = _ties("K5 vs K1", hit.t, hit.tri, k1.t, k1.tri)
    k4 = ts.closest_hit_streamed(pb, o, d, 0.0, tm)
    ties += _ties("K5 vs K4", hit.t, hit.tri, k4.t, k4.tri)
    assert ties == 0  # none on this queue; ties would be allowed


def test_k5_kernel_plain_passes_and_seeds(scene):
    """The plain K5 launch: a block with sid -1 passes its best through; a
    seeded best is only replaced by a strictly nearer hit; any-hit marks a
    blocked lane with its subtree's first row and leaves a lane that
    arrives blocked as it is."""
    pb = scene["pb"]
    o, d = _soa(scene["ro"][:256]), _soa(scene["rd"][:256])
    rays, _ = tr.pack_rays(o, d, 0.0, 2.0e32, 256)
    best = tb.miss_best(256, rays.device)
    L = pb.sub_leaves * ts.LEAF
    for s in range(pb.num_subtrees):
        sid_blk = torch.tensor([s], dtype=torch.int32)
        t, row, u, v = tb.plain(pb, sid_blk, rays, best, 256, False)
        hit = row >= 0
        assert ((row[hit] // L) == s).all()
        # seeded with the result, nothing strictly nearer is left
        again = tb.plain(pb, sid_blk, rays, (t, row, u, v), 256, False)
        for x, y in zip(again, (t, row, u, v)):
            assert torch.equal(x, y)
        blocked = tb.plain(pb, sid_blk, rays, best, 256, True)
        assert torch.equal(blocked[1] >= 0, hit)
        assert (blocked[1][hit] == s * L).all()
        arrived = torch.where(hit, 7, -1).to(torch.int32)
        kept = tb.plain(pb, sid_blk, rays, (best[0], arrived, best[2], best[3]),
                        256, True)
        assert (kept[1][hit] == 7).all()
    none = torch.tensor([-1], dtype=torch.int32)
    seed = (torch.full((256,), 3.0), torch.full((256,), 5, dtype=torch.int32),
            torch.full((256,), 0.25), torch.full((256,), 0.5))
    out = tb.plain(pb, none, rays, seed, 256, False)
    for x, y in zip(out, seed):
        assert torch.equal(x, y)


@pytest.mark.parametrize("any_hit", [False, True])
def test_k5_plain_seeded_edge_cases(scene, any_hit):
    """Plain K5 on seeded edge cases (``test_torch_cuda.k5_edge_operand``,
    which the card test runs through the kernel): a block without a
    subtree and an empty segment (tmax <= tmin) pass the best through;
    in any-hit mode a lane that arrives with a row keeps it; every other
    lane takes its subtree's closest hit, from an uncapped walk of the
    subtree, exactly when it lies before min(t_in, tmax) (any-hit: then
    marks the subtree's first row), else keeps its best; a passed-through
    t is min(t_in, tmax), or 2e32 where the row is -1."""
    pb = scene["pb"]
    o, d = _soa(scene["ro"]), _soa(scene["rd"])
    rays, _ = tr.pack_rays(o, d, 0.0, torch.from_numpy(scene["tmax"]), N_RAYS)
    rays = torch.cat([rays, rays.flip(1)], dim=1)
    sid_blk, q, best = k5_edge_operand(pb, rays)
    t, row, u, v = tb.plain(pb, sid_blk, q, best, 256, any_hit)
    t_in, row_in, u_in, v_in = best
    cap = torch.minimum(t_in, q[7])
    L = pb.sub_leaves * ts.LEAF
    sid = sid_blk.to(torch.int64).repeat_interleave(256)
    h_t = torch.full_like(t_in, 2.0e32)
    h_row = torch.full_like(row_in, -1)
    h_u, h_v = torch.zeros_like(u_in), torch.zeros_like(v_in)
    for s in sid_blk.tolist():
        if s < 0:
            continue
        lanes = sid == s
        h = traverse.closest_hit_threaded(ts.subtree_resident(pb, s),
                                          Vec3(*q[0:3, lanes]), Vec3(*q[3:6, lanes]),
                                          q[6, lanes], q[7, lanes])
        h_t[lanes], h_u[lanes], h_v[lanes] = h.t, h.u, h.v
        h_row[lanes] = torch.where(h.tri >= 0, h.tri + s * L, -1).to(torch.int32)
    live = (sid >= 0) & (cap > q[6]) & ~(any_hit & (row_in >= 0))
    took = live & (h_row >= 0) & (h_t < cap)
    kept_t = torch.where(row_in < 0, 2.0e32, cap)
    if any_hit:
        want = (torch.where(took, cap, kept_t),
                torch.where(took, (sid * L).to(torch.int32), row_in), u_in, v_in)
    else:
        want = (torch.where(took, h_t, kept_t), torch.where(took, h_row, row_in),
                torch.where(took, h_u, u_in), torch.where(took, h_v, v_in))
    for got, exp in zip((t, row, u, v), want):
        assert torch.equal(got, exp)
    passed = sid < 0
    empty = q[7] <= q[6]
    assert passed.any() and (empty & (sid >= 0)).any()
    assert (took & (row_in >= 0)).any() == (not any_hit)
    assert took.any() and (live & ~took & (h_row >= 0)).any()


# ---------------------------------------------------------------------------
# Quantized tiles, the ordered walk, the multislot dispatch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qscene(scene):
    """terrain(48)'s 16-bit quantized packs, the JAX one and the port's."""
    v0, e1, e2 = _flat(GRID)
    return dict(jb=jts.pack_streamed(v0, e1, e2, quantize=True),
                pb=ts.pack_streamed(v0, e1, e2, quantize=True))


@pytest.fixture(scope="module")
def qoracles(scene, qscene):
    """One interpret-mode call of each reference function of this slice on
    the queue: K4 on int16 tiles (sorted), K4's ordered walk (f32), K5's
    any-hit round on int16 tiles, the multislot dispatch on int16 tiles and
    on f32 tiles with one slot (most rays take the K4 cleanup)."""
    jts.INTERPRET = tp2.INTERPRET = jtb.INTERPRET = True
    try:
        jb, jq = scene["jb"], qscene["jb"]
        comps = _jax_comps(scene["ro"], scene["rd"])
        tm, otm = jnp.asarray(scene["tmax"]), jnp.asarray(scene["otm"])
        return dict(
            k4_q=jts.closest_hit_streamed(jq, None, None, t_max=tm,
                                          comps=comps, sort=True),
            k4_ordered=jts.closest_hit_streamed(jb, None, None, t_max=tm,
                                                comps=comps, sort=True,
                                                ordered=True),
            k5_q_occluded=jtb.occluded_binned(jq, None, None, t_max=otm,
                                              comps=comps, rounds=1),
            multislot_q=jtb.closest_hit_binned_all(jq, None, None, t_max=tm,
                                                   comps=comps),
            multislot_1=jtb.closest_hit_binned_all(jb, None, None, t_max=tm,
                                                   comps=comps, k_max=1),
        )
    finally:
        jts.INTERPRET = tp2.INTERPRET = jtb.INTERPRET = False


def test_dequant_matches_reference(qscene):
    """The port's decode of every quantized tile equals the reference's
    ``dequant_tile`` bit for bit, and the decoded rows of every filled slot
    are ``reconstruct_quantized``'s triangle."""
    pb, jb = qscene["pb"], qscene["jb"]
    L = pb.sub_leaves
    dq = ts.dequant_constants(pb)
    tiles = pb.tri_tiles.view(-1, L, 16, ts.LEAF)
    jtiles = np.asarray(jb.tri_tiles).reshape(-1, L, 16, ts.LEAF)
    for s in range(pb.num_subtrees):
        mine = ts.dequant_tile(tiles[s], dq[s]).numpy()
        for leaf in range(L):
            ref = np.asarray(jts.dequant_tile(
                jnp.asarray(jtiles[s, leaf]),
                tuple(jnp.float32(x) for x in dq[s].tolist())))
            np.testing.assert_array_equal(mine[leaf].view(np.uint32),
                                          ref.view(np.uint32))
    v0, e1, e2 = _flat(GRID)
    recon = np.concatenate(ts.reconstruct_quantized(v0, e1, e2), axis=1)
    rows, tri = ts.leaf_rows(pb).numpy(), pb.row_tri.numpy()
    filled = np.zeros(len(rows), bool)  # the rows of every real leaf
    for s in range(pb.num_subtrees):
        links = ts.subtree_resident(pb, s).links
        for leaf in links[:, 1][(links[:, 1] >= 0) & (links[:, 0] > 0)].tolist():
            filled[(s * L + leaf) * ts.LEAF:(s * L + leaf + 1) * ts.LEAF] = True
    np.testing.assert_array_equal(rows[filled].view(np.uint32),
                                  recon[tri[filled]].view(np.uint32))


def test_plain_k4_quantized_and_ordered_match_reference(scene, qscene,
                                                        qoracles):
    """Plain K4 on int16 tiles (sorted) and K4's ordered walk (f32 and
    int16) against the reference kernel in interpret mode; the ordered
    walk against the preorder walk: t bitwise, no tie on this queue."""
    o, d = _soa(scene["ro"]), _soa(scene["rd"])
    tm = torch.from_numpy(scene["tmax"])
    for pb, ref in ((qscene["pb"], qoracles["k4_q"]),
                    (scene["pb"], qoracles["k4_ordered"])):
        pre = ts.closest_hit_streamed(pb, o, d, 0.0, tm, sort=True)
        ordered = ts.closest_hit_streamed(pb, o, d, 0.0, tm, sort=True,
                                          ordered=True)
        _assert_hit_close(pre, ref)
        _assert_hit_close(ordered, ref)
        assert _ties("ordered vs preorder", ordered.t, ordered.tri, pre.t,
                     pre.tri) == 0
        assert 0.3 < (pre.tri >= 0).float().mean() < 0.95
    with pytest.raises(AssertionError, match="closest-hit"):
        ts.plain(scene["pb"], tr.pack_rays(o, d, 0.0, tm, 512)[0], True,
                 ordered=True)


def test_plain_k5_quantized_matches_reference(scene, qscene, qoracles):
    """Plain K5 on int16 tiles: the any-hit round and its K4 cleanup
    against the reference in interpret mode, flags exact; two closest
    rounds against K4 on the same tiles, t bitwise."""
    pb = qscene["pb"]
    o, d = _soa(scene["ro"]), _soa(scene["rd"])
    tm, otm = torch.from_numpy(scene["tmax"]), torch.from_numpy(scene["otm"])
    blocked = tb.occluded_binned(pb, o, d, 0.0, otm, rounds=1)
    np.testing.assert_array_equal(blocked.numpy(),
                                  np.asarray(qoracles["k5_q_occluded"]))
    assert blocked.any() and not blocked.all()
    hit = tb.closest_hit_binned(pb, o, d, 0.0, tm, rounds=2)
    k4 = ts.closest_hit_streamed(pb, o, d, 0.0, tm)
    assert _ties("K5 vs K4, int16", hit.t, hit.tri, k4.t, k4.tri) == 0


@pytest.mark.parametrize("case", ["int16", "f32-one-slot"])
def test_multislot_matches_reference(scene, qscene, qoracles, case):
    """``closest_hit_binned_all`` against the reference's in interpret mode
    (tests/test_traverse_kernels.py:276, :610): on int16 tiles with 8 slots
    and on f32 tiles with one slot, where most rays overflow into the K4
    cleanup; against K4, t bitwise."""
    pb, ref, k_max = ((qscene["pb"], qoracles["multislot_q"], None)
                      if case == "int16" else
                      (scene["pb"], qoracles["multislot_1"], 1))
    o, d = _soa(scene["ro"]), _soa(scene["rd"])
    tm = torch.from_numpy(scene["tmax"])
    before = tb.multislot_dispatches
    hit = tb.closest_hit_binned_all(pb, o, d, 0.0, tm, k_max=k_max)
    assert tb.multislot_dispatches == before + 1
    _assert_hit_close(hit, ref)
    k4 = ts.closest_hit_streamed(pb, o, d, 0.0, tm)
    assert _ties("multislot vs K4", hit.t, hit.tri, k4.t, k4.tri) == 0
    dispatches, overflow, live = tb.multislot_overflow()
    assert dispatches >= 1 and 0 <= overflow <= live
    rays, _ = tr.pack_rays(o, d, 0.0, tm, 512)
    *_, over, sid_blk, prays, _, _ = tb.multislot_operand(pb, rays, 512, k_max)
    assert prays.shape[1] % 512 == 0 and sid_blk.shape[0] == prays.shape[1] // 512
    assert (over.any() if case != "int16" else True)


def test_multislot_negative_t():
    """The multislot merge keeps the most negative t when t_min < 0
    (tests/test_traverse_kernels.py:315): two stacked terrains, origins
    between them looking down, so the upper copy lies behind the origin.
    Against the reference's dispatch in interpret mode and the port's plain
    K1 over a resident BVH of the same triangles."""
    v0, e1, e2 = _terrain(16)
    v0 = np.concatenate([v0, v0 + np.array([0.0, 30.0, 0.0], np.float32)])
    e1, e2 = np.concatenate([e1, e1]), np.concatenate([e2, e2])
    pb = ts.pack_streamed(v0, e1, e2)
    jb = jts.pack_streamed(v0, e1, e2)
    rng = np.random.default_rng(7)
    n = 128
    ro = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    ro[:, 1] = 15.0
    rd = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    rd[:, 0] = rng.uniform(-0.05, 0.05, n)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    o, d = _soa(ro), _soa(rd)
    hit = tb.closest_hit_binned_all(pb, o, d, -100.0, 100.0, block=256)
    jts.INTERPRET = tp2.INTERPRET = jtb.INTERPRET = True
    try:
        ref = jtb.closest_hit_binned_all(jb, None, None, t_min=-100.0,
                                         t_max=100.0, comps=_jax_comps(ro, rd),
                                         block=256)
    finally:
        jts.INTERPRET = tp2.INTERPRET = jtb.INTERPRET = False
    _assert_hit_close(hit, ref)
    fb = tr.pack_resident(bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=128))
    k1 = traverse.map_rows_to_tris(fb, tr.closest_hit_resident(fb, o, d, -100.0,
                                                                100.0))
    assert _ties("multislot vs K1", hit.t, hit.tri, k1.t, k1.tri) == 0
    assert (hit.t[hit.tri >= 0] < 0).all() and (hit.tri >= 0).float().mean() > 0.9


# ---------------------------------------------------------------------------
# Integrator, renderer
# ---------------------------------------------------------------------------


def test_integrator_stream_closest_strategies(scene, qscene):
    """The four ``stream_closest`` strategies, "sorted" (K4), "ordered" (K4
    front to back), "binned" (K5 rounds) and "multislot" (one K5 launch
    over every overlapped subtree), pick the same triangles at the same t,
    on f32 and on 16-bit tiles (tests/test_traverse_kernels.py:636-670);
    shadow rays take one binned round; a typo raises."""
    o, d = _soa(scene["ro"]), _soa(scene["rd"])
    for pb in (scene["pb"], qscene["pb"]):
        ds = ti.DeviceScene(bvh=pb, attr_packed=None, mat_packed=None,
                            lights=None, sky=None)
        hits = {}
        for strategy in ti.STREAM_CLOSEST:
            cfg = ti.IntegratorConfig(max_path_depth=1, streamed=True,
                                      stream_closest=strategy)
            hits[strategy] = ti._closest_hit_dispatch(ds, cfg, o, d, 0.0,
                                                      2.0e32)
        assert (hits["sorted"].tri >= 0).any()
        for strategy in ti.STREAM_CLOSEST:
            assert torch.equal(hits["sorted"].tri, hits[strategy].tri), strategy
            assert torch.equal(hits["sorted"].t, hits[strategy].t), strategy
        blocked = ti._occluded_dispatch(
            ds, ti.IntegratorConfig(streamed=True), o, d, 0.0,
            torch.from_numpy(scene["otm"]))
        assert torch.equal(blocked, tb.occluded_binned(
            pb, o, d, 0.0, torch.from_numpy(scene["otm"]), rounds=1))
    cfg = ti.IntegratorConfig(streamed=True, stream_closest="sortd")
    with pytest.raises(ValueError, match="stream_closest"):
        ti._closest_hit_dispatch(ds, cfg, o, d, 0.0, 2.0e32)


def _port(**kv):
    """Two frames through the port on the CPU: (image, rays per frame,
    renderer, frame config)."""
    with _env(**kv):
        r, cfg = frame_setup("terrain", "cpu", (SIZE, SIZE), DEPTH, GRID)
        rays = []
        for _ in range(FRAMES):
            r.render(cfg)
            rays.append(r.last_frame_rays())
    return r.readback_accumulation(), rays, r, cfg


@pytest.fixture(scope="module")
def renders():
    """The port's streamed and K1 renders of terrain(48), and the JAX
    renderer's (XLA traversal on the CPU) of the same frames."""
    streamed = _port(RPTR_FORCE_STREAMED_TRAVERSAL="1")
    k1 = _port()
    _, _, _, cfg = streamed
    with _env():
        jr = jrend.Renderer()
        jr.initialize(SIZE, SIZE)
        sc = cfg.scene_config
        jr.set_scene(JaxScene.from_vkr_scene(jproc.terrain(grid=GRID)),
                     scene_config=sc)
        jcfg = jrend.FrameConfig(camera=cfg.camera, params=cfg.params,
                                 scene_config=sc)
        jrays = []
        for _ in range(FRAMES):
            jr.render(jcfg)
            jrays.append(sum(int(x) for x in jr._last_rays))
        jax_run = (np.asarray(jr.readback_accumulation()), jrays, jr, jcfg)
    return {"streamed": streamed, "k1": k1, "jax": jax_run}


def test_streamed_route_taken(renders):
    img, rays, r, _ = renders["streamed"]
    assert isinstance(r.device_scene.bvh, ts.StreamedBVHBuffers)
    assert r._route.streamed and r._wavefront is None
    assert r.device_scene.bvh.num_subtrees == 5
    cfg = r._integrator_config(RenderParams(max_path_depth=DEPTH))
    assert cfg.streamed and cfg.stream_closest == "sorted"
    assert not (cfg.kernel_v3 or cfg.compact or cfg.compact_lanes)
    # attributes in source-triangle order: column k is triangle k's
    flat = r.scene.flatten_world()
    np.testing.assert_array_equal(r.device_scene.attr_packed[0:3].numpy(),
                                  np.asarray(flat.e1, np.float32).T)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert img[..., 3].mean() > 0.3
    _, _, rk, _ = renders["k1"]
    assert isinstance(rk.device_scene.bvh, traverse.ResidentBVH)


def test_streamed_frame_equals_k1_route(renders):
    """Same triangles, t, u, v and shading inputs: the image is bitwise
    the K1 route's."""
    img, rays, _, _ = renders["streamed"]
    kimg, krays, _, _ = renders["k1"]
    assert rays == krays
    np.testing.assert_array_equal(img, kimg)


def test_streamed_frame_matches_jax(renders):
    img, rays, _, _ = renders["streamed"]
    jimg, jrays, _, _ = renders["jax"]
    assert rays == jrays
    res = goldens.compare_ref(img[..., :3], jimg[..., :3].astype(np.float64))
    assert res["ok"], res


def test_first_hit_triangles_match_jax_and_k1(renders):
    """Sample 0's primaries: K4's plain version (the route's closest-hit
    dispatch) against the JAX renderer's XLA traversal and the port's K1
    route, triangle for triangle."""
    _, _, r, cfg = renders["streamed"]
    _, _, rk, _ = renders["k1"]
    _, _, jr, _ = renders["jax"]
    px, py, valid, *_ = ti.swizzle_host(SIZE, SIZE)
    basis = cfg.camera.view_basis(SIZE, SIZE)
    jds = jr.device_scene
    jcfg = jr._integrator_config(JaxRenderParams(max_path_depth=DEPTH))
    fp = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(0), jnp.uint32(0))
    st = jps.make_state(0, jnp.uint32(0), jnp.uint32(0), jnp.asarray(px),
                        jnp.asarray(py), SIZE, bufs=jds.rng)
    _, ro, rd = ji.camera_setup(
        jds, jcfg, fp, ji.ViewBuffers(*(jnp.asarray(a) for a in basis)),
        jnp.asarray(px), jnp.asarray(py), jnp.array([SIZE, SIZE], jnp.float32),
        st,
    )
    tri_jax = np.asarray(closest_hit_threaded(
        jds.bvh, ji.v3.to_array(ro), ji.v3.to_array(rd)).tri)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    st = tps.make_state(0, 0, 0, tpx, tpy, SIZE)
    _, ro, rd = ti.camera_setup(
        ti.IntegratorConfig(), ti.ViewBuffers(*(torch.from_numpy(a) for a in basis)),
        tpx, tpy, (float(SIZE), float(SIZE)), st,
    )
    hit = ts.closest_hit_streamed(r.device_scene.bvh, ro, rd, sort=True)
    tri_k1 = traverse.map_rows_to_tris(
        rk.device_scene.bvh, tr.closest_hit_resident(rk.device_scene.bvh, ro, rd)
    ).tri.numpy()
    np.testing.assert_array_equal(hit.tri.numpy()[valid], tri_jax[valid])
    np.testing.assert_array_equal(hit.tri.numpy(), tri_k1)
    assert (tri_jax[valid] >= 0).mean() > 0.3


def test_route_overrides_and_limits(monkeypatch):
    """RPTR_FORCE_STREAMED_TRAVERSAL sends any scene to the streamed route
    (renderer.py:601-604); RPTR_STREAM_CLOSEST is validated as
    renderer.py:1077-1089 validates it, and each of its four strategies
    renders the same frame (test_torch_wavefront.py's test_route_limits
    holds the quantized tiles)."""
    with _env():
        assert trend.route_for(90_001).streamed
        assert not trend.route_for(90_000).streamed
    with _env(RPTR_FORCE_STREAMED_TRAVERSAL="1", RPTR_TRAVERSAL_V3="1"):
        route = trend.route_for(100)
        assert route.streamed and not route.kernel_v3 and not route.compact
    with _env(RPTR_STREAM_CLOSEST="sortd", RPTR_FORCE_STREAMED_TRAVERSAL="1"):
        r, cfg = frame_setup("terrain", "cpu", (16, 16), 2, 16)
        with pytest.raises(ValueError):
            r.render(cfg)
    frames = {}
    for value in ("sorted", "ordered", "binned", "multislot"):
        with _env(RPTR_STREAM_CLOSEST=value, RPTR_FORCE_STREAMED_TRAVERSAL="1"):
            r, cfg = frame_setup("terrain", "cpu", (16, 16), 2, 16)
            r.render(cfg)
            assert r._integrator_config(cfg.params).stream_closest == value
            frames[value] = (r.readback_accumulation(), r.last_frame_rays())
    for value, (img, rays) in frames.items():
        assert rays == frames["sorted"][1], value
        np.testing.assert_array_equal(img, frames["sorted"][0], err_msg=value)
