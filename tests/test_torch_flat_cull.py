"""The port's flat-cull traversal (K2, K3) and coherence sort against the
JAX package's.

The plain versions of K2 and K3 (``ops/traverse_flat.py``, what the
wrappers run on CPU tensors) are held against the reference kernels
``traverse_pallas3.closest_hit_pallas3`` / ``occluded_pallas3`` (K2) and
``closest_hit_pallas4`` / ``occluded_pallas4`` (K3) run in Pallas interpret
mode, on the fixture of tests/test_traverse_kernels.py:676-800
(``_terrain(24)``, leaf 32 and 128, groups 4 and 8, the coherence sort on
and off). Hit triangles and blocked flags must be exact; t, u and v agree
to 1e-5 relative (u, v to 1e-5 absolute), because XLA contracts some of
Möller-Trumbore's multiply-adds into FMAs and the port does not (as for
K1, tests/test_torch_traverse.py). Between the port's own plain versions
there is no such excuse: plain K2, plain K3 and plain K1 agree bitwise.
The port's K3 tests each lane's own leaves (the reference's group of q
lanes shrunk to one); its plain version is held bitwise to the group
version at q = 128 and to plain K1, and to pallas4, on these scenes and
on the tie scene of tests/test_torch_cuda.py flattened to world space.

The port's K2 tests, for each lane, the survivors of its group's broad
phase that its own exact slab test enters (``plain_flat``, K3's function
reached through a group test). Its plain version is held bitwise to
``plain_precull`` and plain K1 in closest, any-hit and merged mode at
q of 32, 64 and 128 lanes and leaf sizes 32, 64 and 128, on ragged
queues with dead and pad lanes, the tie scene and a tie scene whose
equal-t hits the kernel meets out of index order (``lb_tie_scene``); and
to the reference function (``plain_group``: every survivor for every lane)
and ``closest_hit_pallas3`` / ``occluded_pallas3`` at the tolerances
above, the lanes that differ counted and each shown to be grazing (0 on
these scenes; an axis-aligned queue with origins on leaf-box faces
counts its own). The entry bound the kernel sorts by is a lower bound of
every lane's slab entry, and a model of the kernel's sorted walk (early
exit past the best t, ties taken by row) equals the plain version.

The cull itself: the port's leaf boxes and per-ray feeder bits equal the
reference's (``leaf_aabbs_for``, ``leaf_masks_xla``), and K2's union
survivors contain every leaf the per-ray exact test keeps. The coherence
sort's u32 keys and permutation equal the reference's bit for bit.

The CUDA kernels are compared with these plain versions bitwise on the
card, by ``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""

import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.ops import bvh as jbvh
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas as tp1
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas2 as tp2
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas3 as tp3
from realtimepathtracingresearchframework_tpu.ops import wavefront_host as jwf
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import bvh as tbvh
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident as tr
from realtimepathtracingresearchframework_tpu_torch.ops import wavefront_host as twf
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_cuda import lb_tie_scene, tie_world  # noqa: E402
from test_traverse_kernels import _rays, _terrain  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py


@pytest.fixture(autouse=True)
def _interpret_kernels():
    tp2.INTERPRET = True
    tp3.INTERPRET = True
    yield
    tp2.INTERPRET = False
    tp3.INTERPRET = False


@functools.lru_cache(maxsize=None)
def _scene(leaf_size):
    """(reference v3 buffers, port FlatBVH) of the same threaded BVH."""
    tb = jbvh.build_threaded_bvh(*_terrain(24), leaf_size=leaf_size)
    return tp3.pack_for_pallas3(tb), tf.pack_flat(tb)


@functools.lru_cache(maxsize=None)
def _tie_scene(leaf_size):
    """(reference v3 buffers, port FlatBVH) of the tie scene's five
    instances flattened to world space (exact: dyadic coordinates), and its
    rays (ro, rd, tmax, any-hit tmax)."""
    tris, queue = tie_world()
    tb = jbvh.build_threaded_bvh(*tris, leaf_size=leaf_size)
    return (tp3.pack_for_pallas3(tb), tf.pack_flat(tb)), queue


@functools.lru_cache(maxsize=None)
def _lb_tie(leaf_size):
    """(reference v3 buffers, port FlatBVH) of ``lb_tie_scene``, and its
    rays (ro, rd, tmax, any-hit tmax)."""
    arrays, queue = lb_tie_scene(leaf_size)
    return (tp3.pack_for_pallas3(jbvh.ThreadedBVH(**arrays)),
            tf.pack_flat(tbvh.ThreadedBVH(**arrays))), queue


def _soa(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(), t[:, 2].contiguous())


def _queue(rng, kind, n=1024, dead=0.0):
    """(ro, rd, tmax) numpy; a share ``dead`` of lanes has tmax = 0."""
    ro, rd = _rays(n, rng, kind)
    tmax = np.where(rng.uniform(size=len(ro)) < dead, 0.0, 2.0e32)
    return ro, rd, tmax.astype(np.float32)


def _assert_hit_close(port, ref, bvh):
    """Port hit (rows) against a reference hit (tris): ids exact, t/u/v
    within 1e-5 (see the module docstring)."""
    hit = traverse.map_rows_to_tris(bvh, port)
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=0)
    for p, r in ((hit.u, ref.u), (hit.v, ref.v)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def _pack_mask_bits(mask, groups):
    """(G, Lpad) bool -> (nb, Lpad) i32 with bit qi = group qi of the
    block: the mask row format of ``leaf_masks_xla``."""
    bits = mask.reshape(-1, groups, mask.shape[1]).to(torch.int32)
    w = 1 << torch.arange(groups, dtype=torch.int32)
    return (bits * w[None, :, None]).sum(1, dtype=torch.int32)


def _assert_bitwise(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("groups", [4, 8])
@pytest.mark.parametrize("leaf_size", [32, 128])
def test_plain_flat_cull_matches_pallas_interpret(rng, leaf_size, groups):
    """Plain K2 and K3 against pallas3 / pallas4 in interpret mode, sorted
    and unsorted, closest and occluded; and plain K2 == plain K3 == plain
    K1 bitwise."""
    bb3, fb = _scene(leaf_size)
    block = 128 * groups
    for kind in ("coherent", "incoherent"):
        ro, rd, tmax = _queue(rng, kind, dead=0.3)
        o, d, tm = _soa(ro), _soa(rd), torch.from_numpy(tmax)
        jo, jd, jtm = jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmax)
        k1 = tr.closest_hit_resident(fb, o, d, 0.0, tm)
        assert 0.05 < (k1.tri >= 0).float().mean() < 0.7
        # occlusion segments just short of / past each hit
        scale = np.where(rng.uniform(size=len(ro)) < 0.5, 0.999, 1.001)
        otm = np.where(k1.tri.numpy() >= 0, k1.t.numpy() * scale, 8.0)
        otm = np.where(tmax > 0, otm, 0.0).astype(np.float32)
        ob1 = tr.occluded_resident(fb, o, d, 0.0, torch.from_numpy(otm))
        assert ob1.any() and not ob1.all()
        for compact in (False, True):
            kw = dict(block=block, groups=groups, compact=compact)
            for port_c, port_o, ref_c, ref_o in (
                (tf.closest_hit_flat, tf.occluded_flat,
                 tp3.closest_hit_pallas3, tp3.occluded_pallas3),
                (tf.closest_hit_precull, tf.occluded_precull,
                 tp3.closest_hit_pallas4, tp3.occluded_pallas4),
            ):
                hit = port_c(fb, o, d, 0.0, tm, **kw)
                _assert_bitwise(hit, k1)
                _assert_hit_close(hit, ref_c(bb3, jo, jd, t_max=jtm, **kw), fb)
                blocked = port_o(fb, o, d, 0.0, torch.from_numpy(otm), **kw)
                assert torch.equal(blocked, ob1)
                ref = ref_o(bb3, jo, jd, t_max=jnp.asarray(otm), **kw)
                np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref))


@pytest.mark.parametrize("leaf_size", [32, 128])
@pytest.mark.parametrize("scene", ["terrain", "tie"])
def test_per_lane_k3_matches_group_k3_and_pallas4(rng, scene, leaf_size):
    """The port's K3 plain version (each lane's own survivors) equals the
    group version at q = 128 (the OR of the group's exact tests, today's
    reference function) and plain K1 bitwise, and the reference's
    closest_hit_pallas4 / occluded_pallas4 in interpret mode (ids and flags
    exact, t/u/v to the file's tolerance), on ragged queues (pad lanes)
    with dead lanes and empty segments (tmin > tmax); the tie scene's
    exact-t ties keep the lowest row."""
    if scene == "tie":
        (bb3, fb), (ro, rd, tmax, otm) = _tie_scene(leaf_size)
        queues = [(ro, rd, tmax, otm)]
    else:
        bb3, fb = _scene(leaf_size)
        queues = []
        for kind in ("coherent", "incoherent"):
            ro, rd, tmax = _queue(rng, kind, n=1000, dead=0.2)
            k1 = tr.closest_hit_resident(fb, _soa(ro), _soa(rd), 0.0,
                                         torch.from_numpy(tmax))
            scale = np.where(rng.uniform(size=len(ro)) < 0.5, 0.999, 1.001)
            otm = np.where(k1.tri.numpy() >= 0, k1.t.numpy() * scale, 8.0)
            queues.append((ro, rd, tmax, np.where(tmax > 0, otm, 0.0)))
    for ro, rd, tmax, otm in queues:
        n = len(ro)
        # empty segments: tmin 4.5 past tmax 4 on one lane in 13
        empty = np.arange(n) % 13 == 5
        tmin = np.where(empty, 4.5, 0.0).astype(np.float32)
        tmax = np.where(empty, 4.0, tmax).astype(np.float32)
        otm = np.where(empty, 4.0, otm).astype(np.float32)
        o, d = _soa(ro), _soa(rd)
        tmin_t, tmax_t, otm_t = map(torch.from_numpy, (tmin, tmax, otm))
        rays, _ = tr.pack_rays(o, d, tmin_t, tmax_t, 1024)
        orays, _ = tr.pack_rays(o, d, tmin_t, otm_t, 1024)
        assert rays.shape[1] > n  # pad lanes
        for r, any_hit in ((rays, False), (orays, True)):
            lane = tf.plain(tf.K3, fb, r, 128, any_hit)
            group = tf._flush(fb, r, tf.precull_leaf_masks(r, fb.aabbs, 128),
                              128, any_hit)
            if any_hit:
                assert torch.equal(lane, group)
            else:
                _assert_bitwise(lane, group)
        k1 = tr.closest_hit_resident(fb, o, d, tmin_t, tmax_t)
        hit = tf.closest_hit_precull(fb, o, d, tmin_t, tmax_t, block=1024,
                                     groups=8)
        _assert_bitwise(hit, k1)
        assert (hit.tri >= 0).any()
        assert (hit.tri[torch.from_numpy(empty)] == -1).all()
        ref = tp3.closest_hit_pallas4(bb3, jnp.asarray(ro), jnp.asarray(rd),
                                      t_min=jnp.asarray(tmin),
                                      t_max=jnp.asarray(tmax), block=1024,
                                      groups=8)
        _assert_hit_close(hit, ref, fb)
        blocked = tf.occluded_precull(fb, o, d, tmin_t, otm_t, block=1024,
                                      groups=8)
        assert torch.equal(blocked, tr.occluded_resident(fb, o, d, tmin_t, otm_t))
        assert blocked.any() and not blocked[torch.from_numpy(empty)].any()
        ref = tp3.occluded_pallas4(bb3, jnp.asarray(ro), jnp.asarray(rd),
                                   t_min=jnp.asarray(tmin),
                                   t_max=jnp.asarray(otm), block=1024, groups=8)
        np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref))


@pytest.mark.parametrize("groups", [4, 8])
@pytest.mark.parametrize("leaf_size", [32, 128])
def test_leaf_boxes_and_feeder_match_reference(rng, leaf_size, groups):
    """The packed operand, the leaf boxes and the per-ray feeder's packed
    bits equal the reference's (leaf_masks_xla); K2's union survivors
    contain every leaf the per-ray test keeps."""
    bb3, fb = _scene(leaf_size)
    np.testing.assert_array_equal(fb.aabbs.numpy(), np.asarray(bb3.aabbs))
    assert fb.num_leaves == bb3.num_leaves
    np.testing.assert_array_equal(fb.scene_lo.numpy(), np.asarray(bb3.scene_lo))
    np.testing.assert_array_equal(fb.scene_hi.numpy(), np.asarray(bb3.scene_hi))
    block, q = 128 * groups, 128
    for kind in ("coherent", "incoherent"):
        ro, rd, tmax = _queue(rng, kind, n=1000, dead=0.3)
        rays, n = tr.pack_rays(_soa(ro), _soa(rd), 0.0, torch.from_numpy(tmax),
                               block)
        jrays, jn = tp1._prep_rays(jnp.asarray(ro), jnp.asarray(rd), 0.0,
                                   jnp.asarray(tmax), block)
        assert n == jn
        np.testing.assert_array_equal(rays.numpy(), np.asarray(jrays))
        exact = tf.precull_leaf_masks(rays, fb.aabbs, q)
        ref_bits, ref_any = tp3.leaf_masks_xla(jrays, bb3.aabbs, block, groups)
        np.testing.assert_array_equal(
            _pack_mask_bits(exact, groups).numpy(), np.asarray(ref_bits))
        assert exact.any()
        union = tf.flat_leaf_masks(rays, fb.aabbs, q)
        assert not (exact & ~union).any()  # union survivors are a superset
        assert union.sum() >= exact.sum()


def test_dead_and_pad_lanes_miss(rng):
    """tmax <= tmin lanes (and the pad lanes of a ragged queue) come out
    as a miss: t = 2e32, row -1, u = v = 0, not blocked."""
    _, fb = _scene(32)
    ro, rd, _ = _queue(rng, "coherent", n=300)
    o, d = _soa(ro), _soa(rd)
    for fn in (tf.closest_hit_flat, tf.closest_hit_precull):
        hit = fn(fb, o, d, 1.0, 1.0)
        assert hit.t.shape == (len(ro),)
        assert (hit.tri == -1).all() and (hit.t == 2.0e32).all()
        assert (hit.u == 0).all() and (hit.v == 0).all()
    for fn in (tf.occluded_flat, tf.occluded_precull):
        assert not fn(fb, o, d, 2.0, 0.0).any()
    with pytest.raises(ValueError, match="multiple of"):
        tf.closest_hit_flat(fb, o, d, block=500)


def test_coherence_sort_matches_reference(rng):
    """_coherence_key2 bit for bit, _compact's permutation and sorted
    operand equal, the carry key of compaction equal, and K1's
    ``compact`` invisible in its result."""
    bb3, fb = _scene(128)
    ro, rd, tmax = _queue(rng, "incoherent", n=2048, dead=0.4)
    rays, _ = tr.pack_rays(_soa(ro), _soa(rd), 0.0, torch.from_numpy(tmax), 512)
    jrays, _ = tp1._prep_rays(jnp.asarray(ro), jnp.asarray(rd), 0.0,
                              jnp.asarray(tmax), 512)
    lo, hi = bb3.scene_lo, bb3.scene_hi
    key = tr._coherence_key2(rays, fb.scene_lo, fb.scene_hi)
    jkey = np.asarray(tp2._coherence_key2(jrays, lo, hi)).astype(np.int64)
    np.testing.assert_array_equal(key.numpy(), jkey)
    assert len(np.unique(jkey >> 21)) > 8  # octants and dead lanes mixed
    srt, inv = tr._compact(rays, fb.scene_lo, fb.scene_hi)
    jsrt, jinv = tp2._compact(jrays, lo, hi)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(srt.numpy(), np.asarray(jsrt))
    np.testing.assert_array_equal(tr._uncompact(srt, inv).numpy(), rays.numpy())

    live = torch.from_numpy(tmax > 0)
    ck = ti._carry_coherence_key(_soa(ro), _soa(rd), live, fb.scene_lo,
                                 fb.scene_hi)
    jro, jrd = ji.v3.from_array(jnp.asarray(ro)), ji.v3.from_array(jnp.asarray(rd))
    jck = ji._carry_coherence_key(jro, jrd, jnp.asarray(tmax > 0), lo, hi)
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jck).astype(np.int64))

    o, d, tm = _soa(ro), _soa(rd), torch.from_numpy(tmax)
    _assert_bitwise(tr.closest_hit_resident(fb, o, d, 0.0, tm, compact=True),
                    tr.closest_hit_resident(fb, o, d, 0.0, tm))
    assert torch.equal(tr.occluded_resident(fb, o, d, 0.0, tm, compact=True),
                       tr.occluded_resident(fb, o, d, 0.0, tm))


def test_ladder_cover_and_ladder():
    """ladder_cover as tests/test_wavefront_host.py:71-81, and the ladder
    of wavefront_host.py:143-152."""
    ladder = (262144, 524288, 786432)
    for live, want in ((1, 262144), (262144, 262144), (262145, 524288),
                       (786432, 786432), (10**9, 786432)):
        assert twf.ladder_cover(ladder, live) == want
        assert jwf.ladder_cover(ladder, live) == want
    assert twf.make_ladder(1024) == (1024,)
    assert twf.make_ladder(2_097_152) == (32768, 65536, 131072) + tuple(
        range(262144, 2_097_152 + 1, 262144))
    assert twf.make_ladder(200_000) == (32768, 65536, 131072, 200_000)


def _k2_queues(rng, scene, leaf_size, n=1000):
    """(reference buffers, FlatBVH, [(packed rays, packed any-hit rays,
    numpy (ro, rd, tmin, tmax, any-hit tmax))]) of a scene: on the terrain
    a coherent and an incoherent queue of ``n`` rays (20% dead, empty
    segments on one lane in 13, padded to 1024 lanes), any-hit segments
    just short of or past each hit; the tie scenes' own rays."""
    if scene == "terrain":
        bb3, fb = _scene(leaf_size)
        raw = []
        for kind in ("coherent", "incoherent"):
            ro, rd, tmax = _queue(rng, kind, n=n, dead=0.2)
            k1 = tr.closest_hit_resident(fb, _soa(ro), _soa(rd), 0.0,
                                         torch.from_numpy(tmax))
            scale = np.where(rng.uniform(size=len(ro)) < 0.5, 0.999, 1.001)
            otm = np.where(k1.tri.numpy() >= 0, k1.t.numpy() * scale, 8.0)
            raw.append((ro, rd, tmax, np.where(tmax > 0, otm, 0.0)))
    else:
        (bb3, fb), q = (_tie_scene if scene == "tie" else _lb_tie)(leaf_size)
        raw = [q]
    out = []
    for ro, rd, tmax, otm in raw:
        empty = np.arange(len(ro)) % 13 == 5
        tmin = np.where(empty, 4.5, 0.0).astype(np.float32)
        tmax = np.where(empty, 4.0, tmax).astype(np.float32)
        otm = np.where(empty, 4.0, otm).astype(np.float32)
        o, d = _soa(ro), _soa(rd)
        tmin_t, tmax_t, otm_t = map(torch.from_numpy, (tmin, tmax, otm))
        rays, _ = tr.pack_rays(o, d, tmin_t, tmax_t, 1024)
        orays, _ = tr.pack_rays(o, d, tmin_t, otm_t, 1024)
        out.append((rays, orays, (ro, rd, tmin, tmax, otm)))
    return bb3, fb, out


@pytest.mark.parametrize("scene", ["terrain", "tie", "lbtie"])
@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_plain_k2_equals_k3_and_k1(rng, leaf_size, scene):
    """The new plain K2 (each lane's own survivors of its group of
    ``CULL`` lanes) equals plain K3 and plain K1 bitwise in closest,
    any-hit and merged mode, at q = 32, 64 and 128, on ragged queues with
    dead and pad lanes and empty segments, and on a queue whose last group
    is partial."""
    _, fb, queues = _k2_queues(rng, scene, leaf_size)
    for rays, orays, _ in queues:
        assert rays.shape[1] > 512
        k1 = tuple(tr.closest_hit_resident(fb, Vec3(*rays[0:3]),
                                           Vec3(*rays[3:6]), rays[6], rays[7]))
        b1 = tr.occluded_resident(fb, Vec3(*orays[0:3]), Vec3(*orays[3:6]),
                                  orays[6], orays[7])
        k3 = tf.plain_precull(fb, rays, False)
        _assert_bitwise(k3, k1)
        assert torch.equal(tf.plain_precull(fb, orays, True), b1)
        nc = 512
        mixed = torch.cat([rays[:, :nc], orays[:, nc:]], dim=1)
        _assert_bitwise(tf.plain_flat(fb, rays, False), k1)
        assert torch.equal(tf.plain_flat(fb, orays, True), b1)
        _assert_bitwise(tf.plain_flat(fb, rays[:, :-32], False),
                        tuple(x[:-32] for x in k1))
        assert torch.equal(tf.plain_flat(fb, orays[:, :-32], True), b1[:-32])
        for q in (32, 64, 128):
            _assert_bitwise(tf.plain(tf.K2, fb, rays, q, False), k1)
            assert torch.equal(tf.plain(tf.K2, fb, orays, q, True), b1)
            (hm, bm) = tf.merged_plain(fb, mixed, q, nc)
            _assert_bitwise(hm, tuple(x[:nc] for x in k1))
            assert torch.equal(bm, b1[nc:])
        assert (k1[1] >= 0).any() and b1.any()


def _differing(fb, rays, q, any_hit):
    """(lanes where plain K2 and the reference function differ, its
    result, plain K2's)."""
    mine = tf.plain_flat(fb, rays, any_hit)
    ref = tf.plain_group(fb, rays, q, any_hit)
    if any_hit:
        differ = mine != ref
    else:
        differ = ((mine[0].view(torch.int32) != ref[0].view(torch.int32))
                  | (mine[1] != ref[1]))
    return torch.nonzero(differ).squeeze(1), ref, mine


@pytest.mark.parametrize("scene", ["terrain", "tie", "lbtie"])
@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_plain_k2_matches_reference_function_and_pallas3(rng, leaf_size,
                                                         scene):
    """The new plain K2 against the reference function (``plain_group``,
    every survivor tested for every lane of the q-lane group) and against
    closest_hit_pallas3 / occluded_pallas3 in interpret mode: ids and flags
    exact, t/u/v at the file's tolerance. The lanes where it differs from
    the reference function are counted and each is grazing; there are
    none on these scenes."""
    bb3, fb, queues = _k2_queues(rng, scene, leaf_size)
    for rays, orays, (ro, rd, tmin, tmax, otm) in queues:
        n = len(ro)
        for r, any_hit in ((rays, False), (orays, True)):
            lanes, ref, mine = _differing(fb, r, 128, any_hit)
            assert all(tf.grazing(fb, r, lanes, 128, ref, any_hit))
            assert lanes.numel() == 0
        kw = dict(block=512, groups=4, t_min=jnp.asarray(tmin))
        o, d = _soa(ro), _soa(rd)
        hit = tf.closest_hit_flat(fb, o, d, torch.from_numpy(tmin),
                                  torch.from_numpy(tmax))
        assert hit.t.shape == (n,)
        _assert_hit_close(hit, tp3.closest_hit_pallas3(
            bb3, jnp.asarray(ro), jnp.asarray(rd), t_max=jnp.asarray(tmax),
            **kw), fb)
        blocked = tf.occluded_flat(fb, o, d, torch.from_numpy(tmin),
                                   torch.from_numpy(otm))
        np.testing.assert_array_equal(blocked.numpy(), np.asarray(
            tp3.occluded_pallas3(bb3, jnp.asarray(ro), jnp.asarray(rd),
                                 t_max=jnp.asarray(otm), **kw)))


def _axis_rays(fb, rng, n=1024):
    """Axis-aligned rays on leaf-box faces: each lane picks a leaf; its
    origin sits on that leaf's min-x or max-x face (x exactly the face's),
    above the scene, with z inside the leaf's z range or on one of its
    z faces (a box edge); its direction has x = 0 exactly, straight down
    (0, -1, 0) on half the lanes and (0, -0.6, +-0.8) on the rest."""
    box = fb.aabbs[:, :fb.num_leaves].numpy()
    leaf = rng.integers(0, fb.num_leaves, n)
    lo, hi = box[0:3, leaf], box[3:6, leaf]
    x = np.where(rng.uniform(size=n) < 0.5, lo[0], hi[0])
    z = rng.uniform(lo[2], hi[2])
    edge = rng.uniform(size=n) < 0.3
    z = np.where(edge, np.where(rng.uniform(size=n) < 0.5, lo[2], hi[2]), z)
    y = np.full(n, box[4, :fb.num_leaves].max() + 1.0)
    ro = np.stack([x, y, z], 1).astype(np.float32)
    down = rng.uniform(size=n) < 0.5
    sz = np.where(rng.uniform(size=n) < 0.5, 0.8, -0.8)
    rd = np.stack([np.zeros(n), np.where(down, -1.0, -0.6),
                   np.where(down, 0.0, sz)], 1).astype(np.float32)
    return ro, rd


@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_axis_aligned_rays_on_box_faces(rng, leaf_size):
    """Rays whose direction has x = 0 exactly, from origins on leaf-box
    faces (and edges): the new plain K2 still equals plain K1 bitwise, and
    the lanes where it differs from the reference function, closest or
    any-hit, are counted (ROADMAP queue 3 records the count) and each is
    grazing. (These rays run along triangle edges, where XLA's contracted
    FMAs decide Möller-Trumbore's edge test otherwise, so the reference
    kernel is not compared here.)"""
    _, fb = _scene(leaf_size)
    ro, rd = _axis_rays(fb, rng)
    o, d = _soa(ro), _soa(rd)
    rays, n = tr.pack_rays(o, d, 0.0, 2.0e32, 512)
    k1 = tuple(tr.closest_hit_resident(fb, o, d, 0.0, 2.0e32))
    hit = tf.closest_hit_flat(fb, o, d)
    _assert_bitwise(hit, k1)
    assert (hit.tri >= 0).float().mean() > 0.5
    lanes, ref, _ = _differing(fb, rays, 128, False)
    assert all(tf.grazing(fb, rays, lanes, 128, ref, False))
    otm = torch.where(hit.tri >= 0, hit.t * 1.001, 8.0)
    orays, _ = tr.pack_rays(o, d, 0.0, otm, 512)
    olanes, oref, _ = _differing(fb, orays, 128, True)
    assert all(tf.grazing(fb, orays, olanes, 128, oref, True))
    print(f"leaf {leaf_size}: {lanes.numel()} closest and {olanes.numel()} "
          f"any-hit lanes of {n} differ from the reference function")


def _edge_lanes(ro, rd, lanes, tris_a, tris_b):
    """For each lane, whether a hit of either side lies exactly on an edge
    of its triangle: the least |barycentric| (u, v, 1 - u - v) of the ray
    against that triangle, in float64 over the f32 inputs, is 0."""
    v0, e1, e2 = (np.asarray(a, np.float64) for a in _terrain(24))
    out = []
    for i in lanes.tolist():
        o, d = ro[i].astype(np.float64), rd[i].astype(np.float64)
        least = np.inf
        for tri in (int(tris_a[i]), int(tris_b[i])):
            if tri < 0:
                continue
            p = np.cross(d, e2[tri])
            det = e1[tri] @ p
            tv = o - v0[tri]
            u = (tv @ p) / det
            v = (d @ np.cross(tv, e1[tri])) / det
            least = min(least, abs(u), abs(v), abs(1.0 - u - v))
        out.append(least == 0.0)
    return out


@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_axis_aligned_rays_against_reference_k1(rng, leaf_size):
    """The axis-aligned queue of ``test_axis_aligned_rays_on_box_faces``
    through the reference's own kernels in interpret mode: its K1
    (closest_hit_pallas2 / occluded_pallas2) and its K2 (pallas3). The two
    agree on every lane, ids and flags. The port's K2 (= its K1, bitwise)
    differs from them on a counted set of lanes, each an edge lane: the
    port's or the reference's hit lies exactly on an edge of its triangle
    (an exact barycentric of 0), where f32 rounding decides
    Möller-Trumbore's edge test (XLA contracts its FMAs). ROADMAP queue 3
    records the counts: 424 / 446 / 502 closest and 154 / 196 / 301
    any-hit lanes of 1,024 at leaf 32 / 64 / 128 while the per-ray slab
    test missed a box whose face a ray runs along with a zero direction
    component; 165 / 148 / 97 closest and 0 any-hit lanes since it takes
    such an axis as the whole line (``intersect.slab_interval``;
    tests/test_torch_slab.py holds every walk to a brute-force
    Möller-Trumbore there)."""
    bb3, fb = _scene(leaf_size)
    ro, rd = _axis_rays(fb, rng)
    o, d = _soa(ro), _soa(rd)
    hit = traverse.map_rows_to_tris(fb, tf.closest_hit_flat(fb, o, d))
    _assert_bitwise(hit, traverse.map_rows_to_tris(
        fb, tr.closest_hit_resident(fb, o, d, 0.0, 2.0e32)))
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)
    ref_k1 = np.asarray(tp2.closest_hit_pallas2(bb3.bb, jro, jrd, t_max=2.0e32).tri)
    ref_k2 = np.asarray(tp3.closest_hit_pallas3(bb3, jro, jrd, t_max=2.0e32,
                                                block=512, groups=4).tri)
    np.testing.assert_array_equal(ref_k1, ref_k2)
    port = hit.tri.numpy()
    lanes = np.nonzero(port != ref_k1)[0]
    assert all(_edge_lanes(ro, rd, lanes, port, ref_k1))
    otm = torch.where(hit.tri >= 0, hit.t * 1.001, 8.0)
    jotm = jnp.asarray(otm.numpy())
    flag_k1 = np.asarray(tp2.occluded_pallas2(bb3.bb, jro, jrd, t_max=jotm))
    flag_k2 = np.asarray(tp3.occluded_pallas3(bb3, jro, jrd, t_max=jotm,
                                              block=512, groups=4))
    np.testing.assert_array_equal(flag_k1, flag_k2)
    flags = tf.occluded_flat(fb, o, d, 0.0, otm).numpy()
    olanes = np.nonzero(flags != flag_k1)[0]
    # a flag differs only on a lane whose closest hit differs: an edge lane
    assert set(olanes.tolist()) <= set(lanes.tolist())
    assert 0 < lanes.size < len(ro) and (port >= 0).mean() > 0.5
    print(f"leaf {leaf_size}: the port's K2 differs from the reference's K1 "
          f"and K2 on {lanes.size} closest and {olanes.size} any-hit lanes "
          f"of {len(ro)}, every one an edge lane")


@pytest.mark.parametrize("q", [32, 64, 128])
@pytest.mark.parametrize("leaf_size", [32, 128])
def test_entry_bound_is_a_lower_bound(rng, leaf_size, q):
    """For every group, surviving leaf and live lane of the group, the
    broad phase's entry bound lb is at most the lane's slab entry t: a
    lane whose best t is below a survivor's lb cannot enter it."""
    for scene in ("terrain", "lbtie"):
        _, fb, queues = _k2_queues(rng, scene, leaf_size)
        for rays, orays, _ in queues:
            for r in (rays, orays):
                keep, lb = tf.flat_leaf_bounds(r, fb.aabbs, q)
                tn, _ = tf.slab_entry(r, fb.aabbs)
                live = (r[7] > r[6])[:, None]
                lane_keep = keep.repeat_interleave(q, 0) & live
                lane_lb = lb.repeat_interleave(q, 0)
                assert lane_keep.any()
                assert (lane_lb[lane_keep] <= tn[lane_keep]).all()
                # and every leaf a lane's slab test enters survives
                assert not (tf.ray_leaf_hits(r, fb.aabbs) & ~lane_keep).any()


def _sorted_walk(fb, rays, q, any_hit):
    """A model of the kernel's narrow phase: each group's survivors sorted
    by (lb, leaf); the lanes step through them, each testing a survivor
    whose box its slab test on [tmin, cap] enters, cap = best t + |best t| x
    2^-20 (``csrc/flat_cull.cuh::leaf_cap``: a hit on a box's face can lie
    an ulp before the box's f32 entry), the leaf's first least (t, k) taken
    when t < best t or (t == best t and its row is lower); a lane stops
    once a survivor's lb exceeds its cap."""
    ls = fb.leaf_size
    keep, lb = tf.flat_leaf_bounds(rays, fb.aabbs, q)
    n = rays.shape[1]
    t_best = rays[7].clone()
    row = torch.full((n,), -1, dtype=torch.int64)
    u = torch.zeros(n)
    v = torch.zeros(n)
    blocked = torch.zeros(n, dtype=torch.bool)
    live = rays[7] > rays[6]
    for g in range(n // q):
        sl = slice(g * q, (g + 1) * q)
        leaves = torch.nonzero(keep[g, :fb.num_leaves]).squeeze(1).tolist()
        for leaf in sorted(leaves, key=lambda x: (float(lb[g, x]), x)):
            cap = t_best[sl] + t_best[sl].abs() * 2.0 ** -20
            walking = live[sl] & ~blocked[sl] & ~(lb[g, leaf] > cap)
            if not walking.any():
                break
            r = rays[:, sl]
            seg = r.clone()
            seg[7] = cap
            tn, tf_ = tf.slab_entry(seg, fb.aabbs[:, leaf:leaf + 1])
            holds = walking & (tn[:, 0] <= tf_[:, 0])
            rows = fb.tri_rows[leaf * ls:leaf * ls + int(fb.real_rows[leaf])]
            ok, uu, vv, tt = traverse._mt_rows(
                rows[None], *(r[k][:, None] for k in range(6)))
            hit = ok & (tt > r[6][:, None]) & (tt < r[7][:, None])
            if any_hit:
                blocked[sl] |= holds & hit.any(1)
                continue
            tt = torch.where(hit, tt, float("inf"))
            t_leaf = tt.amin(1)
            k = torch.where(tt <= t_leaf[:, None], torch.arange(rows.shape[0]),
                            rows.shape[0]).amin(1).clamp(max=rows.shape[0] - 1)
            cand = leaf * ls + k
            cur_t, cur_row = t_best[sl], row[sl]
            take = holds & torch.isfinite(t_leaf) & (
                (t_leaf < cur_t) | ((t_leaf == cur_t) & (cur_row >= 0)
                                    & (cand < cur_row)))
            t_best[sl] = torch.where(take, t_leaf, cur_t)
            row[sl] = torch.where(take, cand, cur_row)
            u[sl] = torch.where(take, uu.gather(1, k[:, None])[:, 0], u[sl])
            v[sl] = torch.where(take, vv.gather(1, k[:, None])[:, 0], v[sl])
    if any_hit:
        return blocked
    miss = row < 0
    return (torch.where(miss, 2.0e32, t_best), row.to(torch.int32),
            torch.where(miss, 0.0, u), torch.where(miss, 0.0, v))


@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_lb_order_ties_and_sorted_walk(rng, leaf_size):
    """On ``lb_tie_scene`` the sort by entry bound meets leaf 1 before leaf
    0 on every group, so the lanes that tie at t = 5 see the higher row
    first; the plain version, plain K1 and the model of the kernel's sorted
    walk all keep row 0. The model also equals the plain version on a
    coherent terrain queue, closest and any-hit."""
    _, fb, [(rays, orays, _)] = _k2_queues(rng, "lbtie", leaf_size)
    q = tf.CULL
    keep, lb = tf.flat_leaf_bounds(rays, fb.aabbs, q)
    live_groups = (rays[7] > rays[6]).reshape(-1, q).any(1)
    assert (keep[live_groups, 0] & keep[live_groups, 1]).all()
    assert (lb[live_groups, 1] < lb[live_groups, 0]).all()
    plain = tf.plain_flat(fb, rays, False)
    at5 = plain[0] == 5.0
    assert at5.sum() > 100 and (plain[1][at5] == 0).all()
    _assert_bitwise(_sorted_walk(fb, rays, q, False), plain)
    assert torch.equal(_sorted_walk(fb, orays, q, True),
                       tf.plain_flat(fb, orays, True))
    _, fb, queues = _k2_queues(rng, "terrain", leaf_size, n=512)
    rays, orays, _ = queues[0]
    _assert_bitwise(_sorted_walk(fb, rays, q, False),
                    tf.plain_flat(fb, rays, False))
    assert torch.equal(_sorted_walk(fb, orays, q, True),
                       tf.plain_flat(fb, orays, True))


def test_k2_operand_checks():
    """K2's launcher refuses, before any build, a leaf size the kernel does
    not take, lanes that are not whole q-lane groups, and a merged split
    inside a broad-phase group of ``CULL`` lanes; it never falls back to
    the plain version. (The shared-memory cap is the C entry's own check:
    ``tests/test_torch_cuda.py::test_k2_past_the_shared_memory_cap_on_card``.)"""
    _, fb = _scene(32)
    rays, _ = tr.pack_rays(_soa(np.zeros((256, 3))), _soa(np.ones((256, 3))),
                           0.0, 1.0, 128)
    with pytest.raises(ValueError, match="leaf size"):
        tf.bind(tf.K2, fb._replace(leaf_size=16), rays, 128, 128, 1)
    with pytest.raises(ValueError, match="in groups of"):
        tf.bind(tf.K2, fb, rays[:, :96].contiguous(), 64, 0, 0)
    with pytest.raises(ValueError, match="merged split"):
        tf.bind(tf.K2, fb, rays, 32, 64, 2)
