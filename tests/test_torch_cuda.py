"""The port's traversal kernels on the card against their plain versions.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed. On a machine with a CUDA card and nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX). Without a card every
test here skips. ``chip_smoke.py`` runs the same comparisons at the main
paths' shapes. The merged two-queue launches of K1, K2 and K4 are held
against their plain versions and against the kernel's separate launches.
K2 is held against its plain version in every mode at leaf 32, 64 and 128,
at each broad-phase group and leaf service, on ragged queues and on two
tie scenes (one whose equal-t hits it meets out of index order). K1 is held against its plain walk in every mode at leaf 32, 64 and 128,
with each way of serving a leaf; K8a
and K8b (the v1 walk) against their per-lane plain version in all three
modes at each block size and leaf service, K5 at each leaf service; K1,
K8a and K8b also on tables whose leaves hold 1, 5 and all their real rows;
and a CUDA tensor whose kernel does not build raises.
"""

import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_binned as tb
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident as tr
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_stream as ts
from realtimepathtracingresearchframework_tpu_torch.ops import tlas
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas as tt
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_tlas_stream as tts,
)
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_v1 as tv
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _terrain_queue(grid, leaf_size, n, seed):
    """A flat BVH of procedural.terrain(grid) on the card, and a packed
    (8, n) queue of incoherent rays above it, 30% of them dead."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.terrain(grid=grid)).flatten_world()
    tbvh = bvh_mod.build_threaded_bvh(flat.v0, flat.e1, flat.e2,
                                      leaf_size=leaf_size, builder="sah")
    return tf.pack_flat(tbvh, dev), _queue_over(flat, n, seed, dev)


def _streamed_queue(grid, n, seed, quantize=False):
    """The streamed pack of procedural.terrain(grid) on the card (16-bit
    tiles with ``quantize``), and a queue as ``_terrain_queue``'s."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.terrain(grid=grid)).flatten_world()
    bb = ts.pack_streamed(flat.v0, flat.e1, flat.e2, quantize=quantize,
                          device=dev)
    return bb, _queue_over(flat, n, seed, dev)


def _queue_over(flat, n, seed, dev):
    rng = np.random.default_rng(seed)
    lo, hi = flat.v0.min(0), flat.v0.max(0)
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(hi[1], hi[1] + 2.0, n)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.3, 0.0, 2.0e32).astype(np.float32)

    def soa(a):
        t = torch.from_numpy(a).to(dev)
        return Vec3(*(t[:, k].contiguous() for k in range(3)))

    rays, _ = tr.pack_rays(soa(ro), soa(rd), 0.0, torch.from_numpy(tmax).to(dev),
                           1024)
    return rays


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_size", [32, 128])
def test_k1_matches_plain_on_card(leaf_size):
    fb, rays = _terrain_queue(24, leaf_size, 4096, 1)
    o, d = Vec3(*rays[0:3]), Vec3(*rays[3:6])
    before = tr.launches
    hk = tr.closest_hit_resident(fb, o, d, rays[6], rays[7])
    hp = traverse.closest_hit_threaded(fb, o, d, rays[6], rays[7])
    assert tr.launches == before + 1
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    assert (hk.tri >= 0).any()
    tmax = torch.where(hk.tri >= 0, hk.t * 1.001, rays[7])
    assert torch.equal(tr.occluded_resident(fb, o, d, rays[6], tmax),
                       traverse.occluded_threaded(fb, o, d, rays[6], tmax))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [128, 256])
@pytest.mark.parametrize("leaf_size", [32, 128])
@pytest.mark.parametrize("name", [tf.K2, tf.K3])
def test_flat_cull_matches_plain_and_k1_on_card(name, leaf_size, q):
    """K2 and K3 equal their plain versions and K1 bitwise, sorted and
    unsorted, closest and any-hit."""
    fb, rays = _terrain_queue(24, leaf_size, 4096, 2)
    for queue in (rays, tr._compact(rays, fb.scene_lo, fb.scene_hi)[0]):
        o, d = Vec3(*queue[0:3]), Vec3(*queue[3:6])
        k1 = tr.closest_hit_resident(fb, o, d, queue[6], queue[7])
        before = tf.launches_k2 + tf.launches_k3
        k = tf.launch(name, fb, queue, q, False)
        assert tf.launches_k2 + tf.launches_k3 == before + 1
        p = tf.plain(name, fb, queue, q, False)
        for a, b, c in zip(k, p, k1):
            assert torch.equal(a, b) and torch.equal(a, c)
        tmax = torch.where(k1.tri >= 0, k1.t * 1.001, queue[7])
        oq = queue.clone()
        oq[7] = tmax
        blocked = tf.launch(name, fb, oq, q, True)
        assert torch.equal(blocked, tf.plain(name, fb, oq, q, True))
        assert torch.equal(blocked, tr.occluded_resident(fb, o, d, queue[6], tmax))
        assert blocked.any()


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
def test_k4_matches_plain_on_card(quantize):
    """K4 equals its plain version bitwise, sorted and unsorted, closest
    and any-hit, on f32 and 16-bit tiles (terrain(64): 8,192 tris in 8
    subtrees)."""
    bb, rays = _streamed_queue(64, 4096, 3, quantize)
    assert bb.quantized == quantize
    for queue in (rays, ts._sort_operand(bb, rays)[0]):
        before = ts.launches_k4
        k = ts.launch(bb, queue, False)
        assert ts.launches_k4 == before + 1
        p = ts.plain(bb, queue, False)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        assert (k[1] >= 0).any()
        oq = queue.clone()
        oq[7] = torch.where(k[1] >= 0, k[0] * 1.001, queue[7])
        blocked = ts.launch(bb, oq, True)
        assert torch.equal(blocked, ts.plain(bb, oq, True))
        assert blocked.any()


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
def test_k4_ordered_matches_plain_on_card(quantize):
    """K4's ordered walk equals its plain version bitwise, and the preorder
    walk on t bitwise (triangles but for exact-t ties), on f32 and 16-bit
    tiles; it is one launch, counted as ordered."""
    bb, rays = _streamed_queue(64, 4096, 9, quantize)
    queue = ts._sort_operand(bb, rays)[0]
    before = (ts.launches_k4, ts.launches_k4_ordered)
    k = ts.launch(bb, queue, False, ordered=True)
    assert (ts.launches_k4, ts.launches_k4_ordered) == (before[0] + 1,
                                                        before[1] + 1)
    for a, b in zip(k, ts.plain(bb, queue, False, ordered=True)):
        assert torch.equal(a, b)
    pre = ts.launch(bb, queue, False)
    assert torch.equal(k[0], pre[0]) and (k[1] >= 0).any()
    assert int((k[1] != pre[1]).sum()) <= queue.shape[1] // 1000
    with pytest.raises(ValueError, match="closest-hit only"):
        ts._launch(bb, queue, 0, ordered=True)


K5_SCAN_FROM = (1, 8, 16, 24, 32, 33)  # K5's and K8b's leaf services


def k5_edge_operand(bb, rays):
    """A K5 operand of 1,024 lanes in four bin blocks of 256 (subtrees 0,
    none, the last, 1 mod S) from the first 1,024 lanes of a packed (8, n)
    queue, with seeded bests: a third of the lanes arrive with row 7 (u
    0.25, v 0.5) at t_in in [0.5, 30), a third with a miss at such a t_in
    (below tmax), the rest with a miss at 2e32; one lane in 9 an empty
    segment (tmin 5 past tmax 4), one in 11 tmax = tmin = 5. Returns
    (sid_blk, rays, (t, row, u, v))."""
    dev = rays.device
    n = 1024
    rng = np.random.default_rng(41)
    s = bb.num_subtrees
    sid_blk = torch.tensor([0, -1, s - 1, 1 % s], dtype=torch.int32, device=dev)
    rays = rays[:, :n].clone()
    lane = torch.arange(n, device=dev)
    rays[6] = torch.where((lane % 9 == 4) | (lane % 11 == 3), 5.0, rays[6])
    rays[7] = torch.where(lane % 9 == 4, 4.0, rays[7])
    rays[7] = torch.where(lane % 11 == 3, 5.0, rays[7])
    kind = torch.from_numpy(rng.integers(0, 3, n)).to(dev)
    t_in = torch.from_numpy(rng.uniform(0.5, 30.0, n).astype(np.float32)).to(dev)
    t = torch.where(kind < 2, t_in, 2.0e32)
    row = torch.where(kind == 0, 7, -1).to(torch.int32)
    u = torch.where(kind == 0, 0.25, 0.0)
    v = torch.where(kind == 0, 0.5, 0.0)
    return sid_blk, rays.contiguous(), (t, row, u, v)


def _k5_round_operand(bb, rays):
    """The first round's K5 operand of the binned dispatch of ``rays``
    (coherence-sorted, each lane's nearest subtree), in bin blocks of 512:
    (sid_blk, rays, best)."""
    n, dev = rays.shape[1], rays.device
    sb = tb.subtree_bounds(bb)
    srt, _ = tb._coherence_perm(bb, rays)
    sid, _ = tb._next_subtree(
        tb._entry_table(sb, srt), torch.full((n,), -2.0e32, device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev), srt[7])
    sid_blk, prays, pbest, _ = tb.round_operand(
        srt, tb.miss_best(n, dev), sid, sb.shape[0], 512,
        tb.padded_lanes(n, sb.shape[0], 512))
    return sid_blk, prays.contiguous(), tuple(x.contiguous() for x in pbest)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("rounds,shadow", [(2, False), (1, True), (0, True)])
def test_k5_matches_plain_on_card(rounds, shadow, quantize):
    """The binned dispatch through K5 and its K4 cleanup equals the same
    dispatch through their plain versions, bitwise, on f32 and 16-bit
    tiles; and single K5 launches, with each leaf service (``scan_from``),
    equal the plain K5 bitwise on a first-round operand and on seeded edge
    cases (``k5_edge_operand``:
    arriving rows, a block without a subtree, t_in below tmax, empty
    segments)."""
    bb, rays = _streamed_queue(64, 4096, 4, quantize)
    before = tb.launches_k5
    k = tb._run_rounds(bb, rays, 512, rounds, shadow)
    assert tb.launches_k5 == before + rounds
    p = tb._run_rounds(bb, rays, 512, rounds, shadow, plain_versions=True)
    for a, b in zip(k if not shadow else (k,), p if not shadow else (p,)):
        assert torch.equal(a, b)
    for (sid_blk, q, best), block in ((_k5_round_operand(bb, rays), 512),
                                      (k5_edge_operand(bb, rays), 256)):
        want = tb.plain(bb, sid_blk, q, best, block, shadow)
        assert (want[1] >= 0).any()
        for scan_from in (None, *K5_SCAN_FROM):
            got = tb.launch(bb, sid_blk, q, best, block, shadow,
                            scan_from=scan_from)
            _assert_equal_bits(got, want, f"K5 scan_from={scan_from}")


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("k_max", [1, 8])
def test_multislot_matches_plain_on_card(k_max, quantize):
    """The multislot dispatch (one K5 launch and the K4 cleanup) equals the
    same dispatch through the plain versions bitwise, and K4 on t."""
    bb, rays = _streamed_queue(64, 4096, 10, quantize)
    before = (tb.launches_k5, ts.launches_k4)
    k = tb._run_multislot(bb, rays, 512, k_max)
    assert (tb.launches_k5, ts.launches_k4) == (before[0] + 1, before[1] + 1)
    p = tb._run_multislot(bb, rays, 512, k_max, plain_versions=True)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(k[0], ts.plain(bb, rays, False)[0])


def _instanced_queue(num_inst, n, seed):
    """procedural.instanced_field(num_inst) at animation frame 1 on the
    card: K6's pack and K7's (static, frame), and a packed (8, n) queue of
    rays from above the field towards the ground, 30% of them dead."""
    dev = _card()
    scene = Scene.from_vkr_scene(procedural.instanced_field(num_inst=num_inst))
    _, mesh_tris, mesh_ids, mats = scene.flatten_meshes()
    xfs = scene.instance_transforms(1)
    blas = tlas.build_blas_set(mesh_tris)
    nodes, row = tlas.build_tlas_nodes(tlas.instance_world_aabbs(blas, mesh_ids, xfs))
    tables = tlas.build_instance_tables(blas, mesh_ids, mats, xfs)
    bb6 = tt.pack_two_level(tt.pack_blas(mesh_tris, dev), mesh_ids, blas.tri_base,
                            nodes, row, tables["inst_inv"].numpy(),
                            tables["inst_cull_scale"].numpy())
    st7 = tts.pack_tlas_stream_static(mesh_tris, device=dev)
    fr = tts.pack_tlas_stream_frame(st7, mesh_ids, xfs, blas.tri_base)
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(3.0, 12.0, n)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 1] = -np.abs(rd[:, 1])
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.3, 0.0, 2.0e32).astype(np.float32)

    def soa(a):
        t = torch.from_numpy(a).to(dev)
        return Vec3(*(t[:, k].contiguous() for k in range(3)))

    rays, _ = tr.pack_rays(soa(ro), soa(rd), 0.0, torch.from_numpy(tmax).to(dev),
                           512)
    return bb6, (st7, fr), rays


@pytest.mark.cuda
def test_k6_k7_match_plain_on_card():
    """K6 and K7 equal their plain versions bitwise, closest and any-hit,
    K7 sorted and unsorted; K6 = K7 bitwise on t, and on the instance but
    for exact-t ties (40 instances of procedural.instanced_field, within
    K6's caps)."""
    bb6, (st7, fr), rays = _instanced_queue(40, 4096, 5)
    before = tt.launches_k6
    k6 = tt.launch(bb6, rays, False)
    assert tt.launches_k6 == before + 1
    for a, b in zip(k6, tt.plain(bb6, rays, False)):
        assert torch.equal(a, b)
    assert (k6[1] >= 0).any()
    for queue in (rays, tts._sort_operand(fr, rays)[0]):
        before = tts.launches_k7
        k7 = tts.launch(st7, fr, queue, False)
        assert tts.launches_k7 == before + 1
        for a, b in zip(k7, tts.plain(st7, fr, queue, False)):
            assert torch.equal(a, b)
    k7 = tts.launch(st7, fr, rays, False)
    assert torch.equal(k6[0], k7[0])
    h6 = tt.out_to_hit(bb6, k6, rays.shape[1])
    h7 = tts.out_to_hit(st7, fr, k7, rays.shape[1])
    # the two trees visit instances in other orders: an exact-t tie between
    # two instances may go either way
    assert int((h6.inst != h7.inst).sum()) <= rays.shape[1] // 1000
    oq = rays.clone()
    oq[7] = torch.where(k6[1] >= 0, k6[0] * 1.001, rays[7])
    b6 = tt.launch(bb6, oq, True)
    b7 = tts.launch(st7, fr, oq, True)
    assert torch.equal(b6, tt.plain(bb6, oq, True))
    assert torch.equal(b7, tts.plain(st7, fr, oq, True))
    assert torch.equal(b6, b7) and b6.any()


def tie_scene():
    """A two-level scene built for exact-t ties, in numpy: grids of unit
    squares in the plane z = 0 (12x12 and 4x4 squares, two triangles each,
    sharing a diagonal), each with one triangle stored a second time at the
    mesh's last row, in the same leaf; five instances, two pairs of them
    with the same transform (the identity; a 2x scale and a shift) and one
    turned 90 degrees; 512 rays down (some up) that reach the plane at t = 5
    on the grids' vertices, edge midpoints and square centres (on the shared
    diagonals). Every coordinate is a small dyadic number and each
    direction (+-2^-10 or +-2^-11, +-2^-11 or +-2^-10, +-1) keeps a
    triangle's determinant +-1 (+-1/2 on the scaled instances), so t, u and
    v are exact in any evaluation order, every tie is exact, and no slab
    test divides by a zero direction (a ray with dx = 0 on a box's max-x
    face misses the per-ray slab test but not the reference kernel's packet
    test, which then tests every leaf of the packet). Segments: 1 lane
    in 7 dead (tmax = 0), 1 in 5 ending at 4.5, 5 (the hit's t: no hit, the
    test is strict) or 5.5; any-hit segments end at 4.5, 5 or 5.5. Returns
    (meshes, mesh ids, (I, 3, 4) transforms, ro, rd, tmax, any-hit tmax)."""
    def grid(m, dup):
        v0, e1, e2 = [], [], []
        for y in range(m):
            for x in range(m):
                v0 += [[x, y, 0], [x, y, 0]]
                e1 += [[1, 0, 0], [1, 1, 0]]
                e2 += [[1, 1, 0], [0, 1, 0]]
        tri = [np.asarray(a, np.float32) for a in (v0, e1, e2)]
        return tuple(np.concatenate([a, a[dup:dup + 1]]) for a in tri)

    meshes = [grid(12, 41), grid(4, 6)]
    mesh_ids = np.array([0, 0, 1, 1, 1], np.int32)
    xfs = np.zeros((5, 3, 4), np.float32)
    xfs[0:2, :, :3] = np.eye(3)
    xfs[2, :, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    xfs[2, :, 3] = [20, 0, 0]
    xfs[3:5, :, :3] = 2 * np.eye(3)
    xfs[3:5, :, 3] = [-12, 0, 0]
    rng = np.random.default_rng(31)
    half = np.arange(25) / 2
    pts = np.stack(np.meshgrid(half, half), -1).reshape(-1, 2)  # instances 0, 1
    turned = np.stack(np.meshgrid(16 + half[:9], half[:9]), -1).reshape(-1, 2)
    scaled = np.stack(np.meshgrid(-12 + np.arange(9.0), np.arange(9.0)),
                      -1).reshape(-1, 2)
    # points of the repeated triangles (41 of the 12x12 grid: its square
    # (8, 1), upper left; 6 of the 4x4 grid: square (3, 0), lower right)
    ab = np.stack(np.meshgrid(np.arange(5) / 4, np.arange(5) / 4), -1).reshape(-1, 2)
    upper, lower = ab[ab[:, 0] <= ab[:, 1]], ab[ab[:, 0] >= ab[:, 1]]
    copies = np.concatenate([
        [8, 1] + upper,
        np.stack([20 - lower[:, 1], 3 + lower[:, 0]], 1)[::2],  # turned
        np.stack([-6 + 2 * lower[:, 0], 2 * lower[:, 1]], 1)[1::2],  # scaled
    ])
    n0 = 512 - len(turned) - len(scaled) - len(copies)
    xy = np.concatenate([pts[rng.choice(len(pts), n0, replace=False)], turned,
                         scaled, copies])
    n = len(xy)
    up = rng.uniform(size=n) < 0.1  # from below, looking up
    rd = np.stack([rng.choice([-1, 1], n) * rng.choice([2.0**-10, 2.0**-11], n),
                   rng.choice([-1, 1], n) * rng.choice([2.0**-10, 2.0**-11], n),
                   np.where(up, 1.0, -1.0)], 1)
    ro = np.concatenate([xy, np.zeros((n, 1))], 1) - 5.0 * rd
    tmax = np.full(n, 2.0e32)
    tmax[::5] = rng.choice([4.5, 5.0, 5.5], len(tmax[::5]))
    tmax[::7] = 0.0
    otm = np.where(tmax > 0, rng.choice([4.5, 5.0, 5.5], n), 0.0)
    f32 = (lambda a: np.asarray(a, np.float32))
    return meshes, mesh_ids, xfs, f32(ro), f32(rd), f32(tmax), f32(otm)


def tie_world():
    """The tie scene's five instances flattened to world space (v0, e1, e2
    numpy f32; exact: the coordinates stay dyadic), and its rays (ro, rd,
    tmax, any-hit tmax)."""
    meshes, mesh_ids, xfs, ro, rd, tmax, otm = tie_scene()
    tris = [[], [], []]
    for m, xf in zip(mesh_ids, xfs):
        a, t = xf[:, :3], xf[:, 3]
        v0, e1, e2 = meshes[m]
        for out, x in zip(tris, (v0 @ a.T + t, e1 @ a.T, e2 @ a.T)):
            out.append(x.astype(np.float32))
    return tuple(np.concatenate(x) for x in tris), (ro, rd, tmax, otm)


def _packs(meshes, mesh_ids, xfs, dev):
    """K6's pack and K7's (static, frame) of a two-level scene on ``dev``."""
    mats = np.zeros(len(mesh_ids), np.int32)
    blas = tlas.build_blas_set(meshes)
    nodes, row = tlas.build_tlas_nodes(tlas.instance_world_aabbs(blas, mesh_ids, xfs))
    tables = tlas.build_instance_tables(blas, mesh_ids, mats, xfs)
    bb6 = tt.pack_two_level(tt.pack_blas(meshes, dev), mesh_ids, blas.tri_base,
                            nodes, row, tables["inst_inv"].numpy(),
                            tables["inst_cull_scale"].numpy())
    st7 = tts.pack_tlas_stream_static(meshes, device=dev)
    return bb6, (st7, tts.pack_tlas_stream_frame(st7, mesh_ids, xfs,
                                                 blas.tri_base))


def _packed(ro, rd, tmax, dev, tmin=0.0):
    """A packed (8, n) operand of numpy rays on ``dev``, not padded."""
    cols = [ro[:, k] for k in range(3)] + [rd[:, k] for k in range(3)]
    cols += [np.broadcast_to(np.float32(tmin), tmax.shape), tmax]
    return torch.from_numpy(np.stack(cols).astype(np.float32)).to(dev)


def _two_level_modes(bb6, st7, fr, rays, orays, staged):
    """(name, kernel launch, plain version) of every K6 and K7 mode."""
    return (
        ("K6", lambda: tt.launch(bb6, rays, False, staged=staged),
         lambda: tt.plain(bb6, rays, False)),
        ("K6 ordered", lambda: tt.launch(bb6, rays, False, True, staged=staged),
         lambda: tt.plain(bb6, rays, False, True)),
        ("K6 any-hit", lambda: tt.launch(bb6, orays, True, staged=staged),
         lambda: tt.plain(bb6, orays, True)),
        ("K7", lambda: tts.launch(st7, fr, rays, False, staged=staged),
         lambda: tts.plain(st7, fr, rays, False)),
        ("K7 any-hit", lambda: tts.launch(st7, fr, orays, True, staged=staged),
         lambda: tts.plain(st7, fr, orays, True)),
    )


def _assert_modes_equal_plain(modes):
    """Each launch equals its plain version bitwise (floats as bit
    patterns)."""
    for name, launch, plain in modes:
        k, p = launch(), plain()
        for a, b in zip(k, p) if isinstance(k, tuple) else ((k, p),):
            if a.dtype == torch.float32:
                a, b = _bits(a), _bits(b)
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
def test_k6_k7_tie_scene_on_card(staged):
    """On the tie scene every K6 and K7 mode (closest, ordered, any-hit),
    staged and global, equals its plain version bitwise: a leaf's first
    least triangle, and the first visited instance, win exact-t ties."""
    dev = _card()
    meshes, mesh_ids, xfs, ro, rd, tmax, otm = tie_scene()
    bb6, (st7, fr) = _packs(meshes, mesh_ids, xfs, dev)
    rays, orays = _packed(ro, rd, tmax, dev), _packed(ro, rd, otm, dev)
    before = (tt.launches_k6_global, tts.launches_k7_global)
    _assert_modes_equal_plain(_two_level_modes(bb6, st7, fr, rays, orays, staged))
    assert (tt.launches_k6_global - before[0],
            tts.launches_k7_global - before[1]) == ((0, 0) if staged else (3, 2))
    hit = tt.launch(bb6, rays, False, staged=staged)
    assert (hit[1] >= 0).any() and (hit[0][hit[1] >= 0] == 5.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
def test_k6_k7_ragged_queue_on_card(staged):
    """A queue of 1,000,003 lanes, not a whole warp: every K6 and K7 mode,
    staged and global, equals its plain version bitwise (the lanes past n
    of the last warp stay in the walk and write nothing)."""
    bb6, (st7, fr), _ = _instanced_queue(40, 1, 16)
    rng = np.random.default_rng(17)
    n = 1_000_003
    ro = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(3.0, 12.0, n)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.3, 0.0, 2.0e32).astype(np.float32)
    otm = np.where(tmax > 0, rng.uniform(1.0, 40.0, n), 0.0).astype(np.float32)
    dev = bb6.tlas_nodes.device
    rays, orays = _packed(ro, rd, tmax, dev), _packed(ro, rd, otm, dev)
    _assert_modes_equal_plain(_two_level_modes(bb6, st7, fr, rays, orays, staged))


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
def test_k6_k7_empty_segments_on_card(staged):
    """Warps that mix empty segments (tmax = tmin, tmax < tmin, tmin > 0)
    with live rays: every K6 and K7 mode, staged and global, equals its
    plain version bitwise, and no empty segment hits."""
    bb6, (st7, fr), rays = _instanced_queue(40, 4096, 18)
    rays = rays.clone()
    lane = torch.arange(rays.shape[1], device=rays.device)
    rays[7] = torch.where(lane % 3 == 0, 2.0e32, rays[7])
    rays[6] = torch.where(lane % 4 == 1, 5.0, 0.0)
    rays[7] = torch.where(lane % 5 == 2, rays[6], rays[7])  # tmax = tmin
    rays[7] = torch.where(lane % 7 == 3, rays[6] - 1.0, rays[7])  # tmax < tmin
    orays = rays.clone()
    orays[7] = torch.where(rays[7] > rays[6], 20.0, rays[7])
    modes = _two_level_modes(bb6, st7, fr, rays, orays, staged)
    _assert_modes_equal_plain(modes)
    empty = rays[7] <= rays[6]
    assert empty.any() and (~empty).any()
    hit = modes[0][1]()
    assert (hit[1][empty] == -1).all() and (hit[1][~empty] >= 0).any()
    assert not modes[2][1]()[empty].any()


def _edge_rays(bb_lo, bb_hi, n, seed, dev):
    """A packed (8, n) operand, not padded, over a scene box: incoherent
    rays from above, 20% dead, the warp of lanes 256-287 all dead, and
    empty segments (tmin 4.5 past tmax 4) on one lane in 13; and the
    any-hit operand, its segments ending at a random t in [0.5, 8)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bb_lo, np.float32), np.asarray(bb_hi, np.float32)
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(hi[1], hi[1] + 2.0, n)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 1] = -np.abs(rd[:, 1])
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    lane = np.arange(n)
    dead = (rng.uniform(size=n) < 0.2) | ((lane >= 256) & (lane < 288))
    empty = lane % 13 == 5
    tmin = np.where(empty, 4.5, 0.0).astype(np.float32)
    tmax = np.where(dead, 0.0, np.where(empty, 4.0, 2.0e32)).astype(np.float32)
    otm = np.where(tmax > tmin, rng.uniform(0.5, 8.0, n), tmax).astype(np.float32)
    return _packed(ro, rd, tmax, dev, tmin), _packed(ro, rd, otm, dev, tmin)


def _assert_equal_bits(k, p, label):
    """Kernel and plain outputs (a tensor or a tuple) equal bit for bit."""
    _assert_modes_equal_plain(((label, lambda: k, lambda: p),))


def _k4_modes(bb, rays, orays):
    """(name, launch, plain) of every K4 mode on ``rays``: closest unsorted
    and sorted, ordered (sorted), any-hit unsorted and sorted, and merged
    (the closest lanes up to the last whole block of 128, then any-hit)."""
    srt, osrt = ts._sort_operand(bb, rays)[0], ts._sort_operand(bb, orays)[0]
    nc = (rays.shape[1] // 2) // ts.BLOCK * ts.BLOCK
    mixed = torch.cat([rays[:, :nc], orays[:, nc:]], dim=1).contiguous()
    return (
        ("closest", lambda: ts.launch(bb, rays, False),
         lambda: ts.plain(bb, rays, False)),
        ("closest sorted", lambda: ts.launch(bb, srt, False),
         lambda: ts.plain(bb, srt, False)),
        ("ordered", lambda: ts.launch(bb, srt, False, ordered=True),
         lambda: ts.plain(bb, srt, False, ordered=True)),
        ("any-hit", lambda: ts.launch(bb, orays, True),
         lambda: ts.plain(bb, orays, True)),
        ("any-hit sorted", lambda: ts.launch(bb, osrt, True),
         lambda: ts.plain(bb, osrt, True)),
        ("merged", lambda: _flat(ts.merged_launch(bb, mixed, nc)),
         lambda: _flat(ts.merged_plain(bb, mixed, nc))),
    )


def _flat(merged_out):
    """((t, row, u, v), blocked) -> (t, row, u, v, blocked)"""
    return (*merged_out[0], merged_out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
def test_k4_edge_queues_on_card(quantize):
    """Every K4 mode (closest, any-hit, ordered, merged; sorted and not) on
    f32 and 16-bit tiles equals its plain version bitwise on a ragged queue
    of 4,099 lanes (not a whole warp) with dead lanes, an all-dead warp and
    empty segments, which never hit."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.terrain(grid=64)).flatten_world()
    bb = ts.pack_streamed(flat.v0, flat.e1, flat.e2, quantize=quantize,
                          device=dev)
    rays, orays = _edge_rays(flat.v0.min(0), flat.v0.max(0), 4099, 21, dev)
    before = ts.launches_k4
    modes = _k4_modes(bb, rays, orays)
    _assert_modes_equal_plain(modes)
    assert ts.launches_k4 > before
    empty = rays[7] <= rays[6]
    hit = ts.launch(bb, rays, False)
    assert (hit[1][empty] == -1).all() and (hit[1][~empty] >= 0).any()
    blocked = ts.launch(bb, orays, True)
    assert not blocked[empty].any() and blocked.any()


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
def test_k4_tie_scene_on_card(quantize):
    """On the tie scene's triangles in one streamed pack, every K4 mode
    equals its plain version bitwise: a leaf's first least triangle and the
    first visited subtree win exact-t ties (f32; the 16-bit grid moves the
    vertices, and the kernel still equals its plain version)."""
    dev = _card()
    (v0, e1, e2), (ro, rd, tmax, otm) = tie_world()
    bb = ts.pack_streamed(v0, e1, e2, quantize=quantize, device=dev)
    rays, orays = _packed(ro, rd, tmax, dev), _packed(ro, rd, otm, dev)
    _assert_modes_equal_plain(_k4_modes(bb, rays, orays))
    if not quantize:
        hit = ts.launch(bb, rays, False)
        assert (hit[1] >= 0).any() and (hit[0][hit[1] >= 0] == 5.0).all()


def _flat_pack(v0, e1, e2, leaf_size, dev):
    tbvh = bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=leaf_size,
                                      builder="sah")
    return tf.pack_flat(tbvh, dev)


def _k3_modes(fb, rays, orays, scan_from):
    """(name, launch, plain) of K3 closest and any-hit, unsorted and
    coherence-sorted, with the leaf service ``scan_from``."""
    srt = tr._compact(rays, fb.scene_lo, fb.scene_hi)[0]
    osrt = tr._compact(orays, fb.scene_lo, fb.scene_hi)[0]
    return tuple(
        (f"{'any-hit' if a else 'closest'} {name} scan_from={scan_from}",
         (lambda q=q, a=a: tf.launch(tf.K3, fb, q, 128, a, scan_from)),
         (lambda q=q, a=a: tf.plain(tf.K3, fb, q, 128, a)))
        for name, q, a in (("unsorted", rays, False), ("sorted", srt, False),
                           ("unsorted", orays, True), ("sorted", osrt, True)))


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_k3_edge_queues_on_card(leaf_size):
    """K3 closest and any-hit, sorted and not, equals its plain version
    (each lane's own leaves) bitwise at leaf sizes 32, 64 and 128, with
    each leaf served by the warp, by its holders alone, and by the default
    rule, on a queue with dead lanes, an all-dead warp and empty segments;
    and K1 and the reference's group-of-128 function (plain, q = 128)."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.terrain(grid=48)).flatten_world()
    fb = _flat_pack(flat.v0, flat.e1, flat.e2, leaf_size, dev)
    rays, orays = _edge_rays(flat.v0.min(0), flat.v0.max(0), 4096, 22, dev)
    before = tf.launches_k3
    for scan_from in (33, 1, tf.SCAN_FROM):
        _assert_modes_equal_plain(_k3_modes(fb, rays, orays, scan_from))
    assert tf.launches_k3 == before + 12
    hit = tf.launch(tf.K3, fb, rays, 128, False)
    group = tf._flush(fb, rays, tf.precull_leaf_masks(rays, fb.aabbs, 128),
                      128, False)
    k1 = tr.closest_hit_resident(fb, Vec3(*rays[0:3]), Vec3(*rays[3:6]),
                                 rays[6], rays[7])
    _assert_equal_bits(hit, tuple(group), "K3 vs group plain")
    _assert_equal_bits(hit, tuple(k1), "K3 vs K1")
    empty = rays[7] <= rays[6]
    assert (hit[1][empty] == -1).all() and (hit[1][~empty] >= 0).any()
    blocked = tf.launch(tf.K3, fb, orays, 128, True)
    assert not blocked[empty].any() and blocked.any()
    assert torch.equal(blocked, tr.occluded_resident(
        fb, Vec3(*orays[0:3]), Vec3(*orays[3:6]), orays[6], orays[7]))


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_k3_tie_scene_on_card(leaf_size):
    """On the tie scene flattened to world space, K3 closest and any-hit,
    with each way of serving a leaf, equals its plain version and K1
    bitwise: the lowest row wins an exact-t tie."""
    dev = _card()
    (v0, e1, e2), (ro, rd, tmax, otm) = tie_world()
    fb = _flat_pack(v0, e1, e2, leaf_size, dev)
    n = len(ro)
    rays, orays = _packed(ro, rd, tmax, dev), _packed(ro, rd, otm, dev)
    for scan_from in (33, 1, tf.SCAN_FROM):
        _assert_modes_equal_plain(_k3_modes(fb, rays, orays, scan_from))
    hit = tf.launch(tf.K3, fb, rays, 128, False)
    k1 = tr.closest_hit_resident(fb, Vec3(*rays[0:3]), Vec3(*rays[3:6]),
                                 rays[6], rays[7])
    _assert_equal_bits(hit, tuple(k1), "K3 vs K1")
    assert n % 128 == 0 and (hit[0][hit[1] >= 0] == 5.0).all()


@pytest.mark.cuda
def test_k3_past_the_old_shared_memory_cap_on_card():
    """A flat BVH whose leaf count the first K3 refused (its survivor list
    and flags, 8 bytes a padded leaf, and a staged leaf over 48 KB of
    shared memory): terrain(320) at leaf 32, 6,400 padded leaves. K3 equals
    its plain version and K1 bitwise, closest and any-hit."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.terrain(grid=320)).flatten_world()
    fb = _flat_pack(flat.v0, flat.e1, flat.e2, 32, dev)
    lpad = fb.aabbs.shape[1]
    assert 8 * lpad + 36 * fb.leaf_size > 48 * 1024
    rays, orays = _edge_rays(flat.v0.min(0), flat.v0.max(0), 4096, 23, dev)
    _assert_modes_equal_plain(_k3_modes(fb, rays, orays, tf.SCAN_FROM))
    hit = tf.launch(tf.K3, fb, rays, 128, False)
    k1 = tr.closest_hit_resident(fb, Vec3(*rays[0:3]), Vec3(*rays[3:6]),
                                 rays[6], rays[7])
    _assert_equal_bits(hit, tuple(k1), "K3 vs K1")
    assert (hit[1] >= 0).any()


def lb_tie_scene(leaf_size):
    """A flat BVH of two leaves whose equal-t hits K2 visits out of index
    order, as numpy arrays (``ThreadedBVH``'s fields, for either package's
    class), and its rays (ro, rd, tmax, any-hit tmax). Leaf 0 holds the
    triangle v0 (0, 0, 0), e1 (16, 0, 0), e2 (0, 16, 0) in the plane z = 0;
    leaf 1 holds the same triangle again and a small one at z = 2 off to
    the side, so its box reaches up to z = 2. The rays come down from z = 5
    (direction (+-2^-10 or +-2^-11, the same, -1)) over the big triangle:
    every value of Möller-Trumbore is exact, both copies give t = 5, and
    leaf 1's entry bound (3) sorts it before leaf 0's (5), so the kernel
    meets the higher row first and must still keep row 0. Segments: 1 lane
    in 7 dead, 1 in 5 ending at 4.5, 5 (no hit: the test is strict) or
    5.5; any-hit segments end at 4.5, 5 or 5.5; 1 lane in 9 aims at the
    small triangle (a hit at t = 3)."""
    ls = leaf_size
    big = [[0, 0, 0], [16, 0, 0], [0, 16, 0]]
    small = [[20, 20, 2], [1, 0, 0], [0, 1, 0]]
    leaf0, leaf1 = [big] * ls, [big, small] + [small] * (ls - 2)
    tris = np.asarray(leaf0 + leaf1, np.float32)  # (2 ls, 3, 3)
    rows = np.zeros((2 * ls, 12), np.float32)
    rows[:, 0:9] = tris.reshape(-1, 9)
    row_tri = np.asarray([0] * ls + [1] + [2] * (ls - 1), np.int32)
    v = [tris[:, 0], tris[:, 0] + tris[:, 1], tris[:, 0] + tris[:, 2]]
    lo, hi = np.minimum.reduce(v), np.maximum.reduce(v)

    def box(r):
        return np.concatenate([lo[r].min(0), hi[r].max(0)])

    def link(x):
        return np.asarray(x, np.int32).view(np.float32)

    nodes = np.zeros((3, 8), np.float32)
    for k, (r, skip, first) in enumerate(((slice(None), 3, -1),
                                          (slice(0, ls), 2, 0),
                                          (slice(ls, None), 3, ls))):
        nodes[k, 0:6] = box(r)
        nodes[k, 6], nodes[k, 7] = link(skip), link(first)
    arrays = dict(nodes=nodes, tri_rows=rows, row_tri=row_tri, depth=2,
                  world_min=nodes[0, 0:3].copy(), world_max=nodes[0, 3:6].copy(),
                  leaf_size=ls)
    rng = np.random.default_rng(37)
    n = 512
    xy = rng.integers(1, 32, (n, 2)) / 4.0  # x + y < 16: inside the big one
    xy[::9] = [20.5, 20.5]
    rd = np.stack([rng.choice([-1, 1], n) * rng.choice([2.0**-10, 2.0**-11], n),
                   rng.choice([-1, 1], n) * rng.choice([2.0**-10, 2.0**-11], n),
                   -np.ones(n)], 1)
    ro = np.concatenate([xy, np.zeros((n, 1))], 1) - 5.0 * rd
    ro[::9, 2] = 5.0
    tmax = np.full(n, 2.0e32)
    tmax[::5] = rng.choice([4.5, 5.0, 5.5], len(tmax[::5]))
    tmax[::7] = 0.0
    otm = np.where(tmax > 0, rng.choice([4.5, 5.0, 5.5], n), 0.0)
    f32 = (lambda a: np.asarray(a, np.float32))
    return arrays, (f32(ro), f32(rd), f32(tmax), f32(otm))


def _k2_modes(fb, rays, orays, q, scan_from=None):
    """(name, launch, plain) of K2 closest and any-hit, unsorted and
    coherence-sorted, and merged (half the lanes, rounded to a broad-phase
    group of 128, closest), in q-lane groups and with the leaf service
    ``scan_from``: each launch bound (``tf.bind``) and run."""
    srt = tr._compact(rays, fb.scene_lo, fb.scene_hi)[0]
    osrt = tr._compact(orays, fb.scene_lo, fb.scene_hi)[0]
    nc = (rays.shape[1] // 2) // 128 * 128
    mixed = torch.cat([rays[:, :nc], orays[:, nc:]], dim=1).contiguous()

    def run(op, n_closest):
        go, c, b = tf.bind(tf.K2, fb, op, q, n_closest, n_closest // q,
                           scan_from)
        assert go() == 0
        return (*(c if n_closest else ()),
                *((b,) if n_closest < op.shape[1] else ()))

    def plain(op, n_closest):
        out = ()
        if n_closest:
            out += tuple(tf.plain_flat(fb, op[:, :n_closest], False))
        if n_closest < op.shape[1]:
            out += (tf.plain_flat(fb, op[:, n_closest:], True),)
        return out

    return tuple(
        (f"{name} q={q} scan_from={scan_from}",
         (lambda op=op, k=k: run(op, k)), (lambda op=op, k=k: plain(op, k)))
        for name, op, k in (("closest", rays, rays.shape[1]),
                           ("closest sorted", srt, rays.shape[1]),
                           ("any-hit", orays, 0), ("any-hit sorted", osrt, 0),
                           ("merged", mixed, nc)))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [32, 64, 128])
@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_k2_edge_queues_on_card(leaf_size, q):
    """K2 closest, any-hit and merged, sorted and not, equals its plain
    version bitwise at leaf sizes 32, 64 and 128 and q of 32, 64 and 128
    lanes, with each leaf served by the warp, by its holders alone and by
    the default rule, on a queue with dead lanes, an all-dead warp and
    empty segments, and on one whose last broad-phase group is partial (q
    32 and 64);
    and K3's plain version and K1."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.terrain(grid=48)).flatten_world()
    fb = _flat_pack(flat.v0, flat.e1, flat.e2, leaf_size, dev)
    rays, orays = _edge_rays(flat.v0.min(0), flat.v0.max(0), 4096, 24, dev)
    for scan_from in (33, 1, None):
        _assert_modes_equal_plain(_k2_modes(fb, rays, orays, q, scan_from))
    part = rays[:, :-q].contiguous()  # at q 32 and 64 a partial last group
    _assert_equal_bits(tf.launch(tf.K2, fb, part, q, False),
                       tuple(tf.plain_flat(fb, part, False)), "partial group")
    hit = tf.launch(tf.K2, fb, rays, 128, False)
    k1 = tr.closest_hit_resident(fb, Vec3(*rays[0:3]), Vec3(*rays[3:6]),
                                 rays[6], rays[7])
    _assert_equal_bits(hit, tuple(tf.plain_precull(fb, rays, False)), "K2 vs K3")
    _assert_equal_bits(hit, tuple(k1), "K2 vs K1")
    empty = rays[7] <= rays[6]
    assert (hit[1][empty] == -1).all() and (hit[1][~empty] >= 0).any()
    blocked = tf.launch(tf.K2, fb, orays, 128, True)
    assert not blocked[empty].any() and blocked.any()
    assert torch.equal(blocked, tr.occluded_resident(
        fb, Vec3(*orays[0:3]), Vec3(*orays[3:6]), orays[6], orays[7]))


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_k2_tie_scenes_on_card(leaf_size):
    """On the tie scene flattened to world space and on ``lb_tie_scene``
    (equal-t hits met out of index order), K2 in every mode, q and leaf
    service equals its plain version, and K1 bitwise: the lowest row wins
    an exact-t tie."""
    dev = _card()
    (v0, e1, e2), (ro, rd, tmax, otm) = tie_world()
    arrays, lb_rays = lb_tie_scene(leaf_size)
    scenes = ((_flat_pack(v0, e1, e2, leaf_size, dev), (ro, rd, tmax, otm)),
              (tf.pack_flat(bvh_mod.ThreadedBVH(**arrays), dev), lb_rays))
    for fb, (ro, rd, tmax, otm) in scenes:
        rays, orays = _packed(ro, rd, tmax, dev), _packed(ro, rd, otm, dev)
        for q in (32, 64, 128):
            for scan_from in (33, 1, None):
                _assert_modes_equal_plain(_k2_modes(fb, rays, orays, q,
                                                    scan_from))
        hit = tf.launch(tf.K2, fb, rays, 128, False)
        k1 = tr.closest_hit_resident(fb, Vec3(*rays[0:3]), Vec3(*rays[3:6]),
                                     rays[6], rays[7])
        _assert_equal_bits(hit, tuple(k1), "K2 vs K1")
        assert (hit[1] >= 0).any()
    at5 = hit[0] == 5.0
    assert at5.any() and (hit[1][at5] == 0).all()


@pytest.mark.cuda
def test_k2_past_the_shared_memory_cap_on_card():
    """A scene whose survivor list (8 bytes a leaf) would pass 47 KB of
    shared memory: K2's C entry refuses it, the error names the leaf
    count, and nothing falls back to the plain version."""
    fb, rays = _terrain_queue(24, 32, 256, 3)
    big = fb._replace(num_leaves=47 * 1024 // 8 + 1)
    before = tf.launches_k2
    with pytest.raises(RuntimeError, match=f"{big.num_leaves} leaves"):
        tf.launch(tf.K2, big, rays, 128, False)
    assert tf.launches_k2 == before


def _merged_operand(kernel, n_closest, seed):
    """The scene of ``kernel`` on the card and a merged (8, n) operand: its
    first ``n_closest`` lanes a closest queue, the rest a shadow queue whose
    segments end just short of (0.999 t) or past (1.001 t) each closest hit
    of those rays. Returns (scene, operand); the flat BVH of K2 serves K1
    too."""
    if kernel == "K4":
        bb, rays = _streamed_queue(64, 4096, seed)
        hits = ts.plain(bb, rays, False)
    else:
        bb, rays = _terrain_queue(24, 128, 4096, seed)
        hits = tuple(tr.closest_hit_resident(bb, Vec3(*rays[0:3]), Vec3(*rays[3:6]),
                                             rays[6], rays[7]))
    t, row = hits[0], hits[1]
    scale = torch.where(torch.arange(rays.shape[1], device=rays.device) % 2 == 0,
                        0.999, 1.001)
    merged = rays.clone()
    merged[7, n_closest:] = torch.where(row >= 0, t * scale, rays[7])[n_closest:]
    return bb, merged


def _separate(kernel, bb, rays, n_closest):
    """The same two queues as two launches of the kernel's own modes."""
    c, s = rays[:, :n_closest].contiguous(), rays[:, n_closest:].contiguous()
    if kernel == "K1":
        def launch(q, any_hit):
            fn = tr.occluded_resident if any_hit else tr.closest_hit_resident
            return fn(bb, Vec3(*q[0:3]), Vec3(*q[3:6]), q[6], q[7])
    elif kernel == "K2":
        def launch(q, any_hit):
            return tf.launch(tf.K2, bb, q, 128, any_hit)
    else:
        def launch(q, any_hit):
            return ts.launch(bb, q, any_hit)
    return tuple(launch(c, False)), launch(s, True)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4"])
def test_merged_launch_matches_plain_and_separate_on_card(kernel):
    """One merged launch (2,048 closest lanes, then 2,048 shadow lanes)
    equals its plain version and the kernel's two separate launches,
    bitwise, and counts as one launch."""
    bb, rays = _merged_operand(kernel, 2048, 6)
    if kernel == "K1":
        mod, counts = tr, lambda: (tr.launches, tr.merged_launches)
        launch, plain = tr.merged_launch, tr.merged_plain
    elif kernel == "K2":
        mod, counts = tf, lambda: (tf.launches_k2, tf.merged_launches_k2)
        launch = lambda b, q, n: tf.merged_launch(b, q, 128, n)  # noqa: E731
        plain = lambda b, q, n: tf.merged_plain(b, q, 128, n)  # noqa: E731
    else:
        mod, counts = ts, lambda: (ts.launches_k4, ts.merged_launches_k4)
        launch, plain = ts.merged_launch, ts.merged_plain
    before = counts()
    (hk, bk) = launch(bb, rays, 2048)
    assert counts() == (before[0] + 1, before[1] + 1), mod.__name__
    hp, bp = plain(bb, rays, 2048)
    hs, bs = _separate(kernel, bb, rays, 2048)
    for a, b, c in zip(hk, hp, hs):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(bk, bp) and torch.equal(bk, bs)
    assert (hk[1] >= 0).any() and bk.any() and not bk.all()


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
def test_merged_wrappers_on_card(sort):
    """The three public merged wrappers on queues that are not whole blocks
    (1,500 closest, 1,000 shadow lanes) equal the separate wrappers of the
    same kernel bitwise, with each half coherence-sorted or not."""
    fb, rays = _merged_operand("K1", 1500, 7)
    bb, srays = _merged_operand("K4", 1500, 8)
    for name, scene, q in (("K1", fb, rays), ("K2", fb, rays), ("K4", bb, srays)):
        q = q[:, :2500]
        cc, cs = tuple(q[0:6, :1500]), tuple(q[0:6, 1500:])
        args = (cc, q[6, :1500], q[7, :1500], cs, q[6, 1500:], q[7, 1500:])
        oc, os_ = Vec3(*q[0:3, :1500]), Vec3(*q[0:3, 1500:])
        dc, ds = Vec3(*q[3:6, :1500]), Vec3(*q[3:6, 1500:])
        if name == "K1":
            hit, blocked = tr.closest_and_occluded_resident(scene, *args, compact=sort)
            sep = tr.closest_hit_resident(scene, oc, dc, *args[1:3], compact=sort)
            sep_b = tr.occluded_resident(scene, os_, ds, *args[4:6], compact=sort)
        elif name == "K2":
            hit, blocked = tf.closest_and_occluded_flat(scene, *args, compact=sort)
            sep = tf.closest_hit_flat(scene, oc, dc, *args[1:3], compact=sort)
            sep_b = tf.occluded_flat(scene, os_, ds, *args[4:6], compact=sort)
        else:
            hit, blocked = ts.closest_and_occluded_streamed(scene, *args, sort=sort)
            sep = ts.closest_hit_streamed(scene, oc, dc, *args[1:3], sort=sort)
            sep_b = ts.occluded_streamed(scene, os_, ds, *args[4:6], sort=sort)
        for a, b in zip(hit, sep):
            assert torch.equal(a, b), name
        assert torch.equal(blocked, sep_b), name


@pytest.mark.cuda
def test_k6_ordered_matches_plain_on_card():
    """K6's ordered instance walk equals its plain version bitwise, and the
    preorder walk on t bitwise (instances but for exact-t ties)."""
    bb6, _, rays = _instanced_queue(40, 4096, 11)
    before = (tt.launches_k6, tt.launches_k6_ordered)
    k = tt.launch(bb6, rays, False, ordered=True)
    assert (tt.launches_k6, tt.launches_k6_ordered) == (before[0] + 1,
                                                        before[1] + 1)
    for a, b in zip(k, tt.plain(bb6, rays, False, ordered=True)):
        assert torch.equal(a, b)
    pre = tt.launch(bb6, rays, False)
    assert torch.equal(k[0], pre[0]) and (k[1] >= 0).any()
    assert int((k[4] != pre[4]).sum()) <= rays.shape[1] // 1000


@pytest.mark.cuda
def test_k7_global_matches_staged_on_card():
    """K7 reading its top tree from global memory equals K7 staging it in
    shared memory and the plain version bitwise, closest and any-hit; the
    mode picked by size stages a small top tree; each global launch is
    counted."""
    _, (st7, fr), rays = _instanced_queue(40, 4096, 12)
    assert tt.top_staged(tts.top_bytes(fr))
    before = (tts.launches_k7, tts.launches_k7_global)
    g = tts.launch(st7, fr, rays, False, staged=False)
    assert (tts.launches_k7, tts.launches_k7_global) == (before[0] + 1,
                                                         before[1] + 1)
    s = tts.launch(st7, fr, rays, False)
    assert tts.launches_k7_global == before[1] + 1
    for a, b, c in zip(g, s, tts.plain(st7, fr, rays, False)):
        assert torch.equal(a, b) and torch.equal(a, c)
    oq = rays.clone()
    oq[7] = torch.where(g[1] >= 0, g[0] * 1.001, rays[7])
    assert torch.equal(tts.launch(st7, fr, oq, True, staged=False),
                       tts.launch(st7, fr, oq, True, staged=True))


def _v1_queue(grid, n, seed):
    """The v1 pack of procedural.terrain(grid) (leaf-128 SAH tree) on the
    card, and a packed (8, n) queue as ``_terrain_queue``'s."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.terrain(grid=grid)).flatten_world()
    tbvh = bvh_mod.build_threaded_bvh(flat.v0, flat.e1, flat.e2,
                                      leaf_size=tv.LEAF, builder="sah")
    return tv.pack_v1(tbvh, dev), _queue_over(flat, n, seed, dev)


def _bits(x):
    return x.contiguous().view(torch.int32)


K8_LAUNCHES = tuple((t, None) for t in (None, 128, 256, 512)) + tuple(
    (None, f) for f in K5_SCAN_FROM)  # (threads, scan_from) of K8a and K8b


def _k8_modes(vb, rays8, orays8):
    """(name, launch, plain) of K8's three modes on packed (8, n) queues
    given in the table's layout (K8a and K8b against the per-lane
    ``plain_lanes``) at each block size and leaf service: closest, any-hit
    on ``orays8``, and a merged launch whose last quarter of packets takes
    the any-hit mode."""
    def op(q):
        return q if vb.wide else q.t().contiguous()

    nc = rays8.shape[1] * 3 // 4 // tv.BLOCK * tv.BLOCK
    mixed = torch.cat([rays8[:, :nc], orays8[:, nc:]], dim=1).contiguous()
    plain = tv.plain_lanes
    modes = []
    for threads, scan_from in K8_LAUNCHES:
        kw = dict(threads=threads, scan_from=scan_from)
        for name, q, a, sf in (("closest", rays8, False, -1),
                               ("anyhit", orays8, True, -1),
                               ("merged", mixed, False, nc // tv.BLOCK)):
            modes.append((f"{name} threads={threads} scan_from={scan_from}",
                          (lambda q=q, a=a, sf=sf, kw=kw:
                           tv.launch(vb, op(q), a, sf, **kw)),
                          (lambda q=q, a=a, sf=sf: plain(vb, op(q), a, sf))))
    return modes


def _short_of_hits(vb, rays8):
    """The any-hit queue of ``rays8``: segments ending just short of (0.999
    t) or past (1.001 t) each closest hit of the per-lane walk."""
    out = tv.plain_lanes(vb, rays8 if vb.wide else rays8.t().contiguous(), False)
    t = out[0] if vb.wide else out[:, 0]
    scale = torch.where(torch.arange(t.shape[0], device=t.device) % 2 == 0,
                        0.999, 1.001)
    orays8 = rays8.clone()
    orays8[7] = torch.where(t < 1e30, t * scale, rays8[7])
    return orays8


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "anyhit", "merged"])
@pytest.mark.parametrize("grid", [30, 69])
def test_k8_matches_plain_on_card(grid, mode):
    """K8a (terrain(30), 1,800 tris, the row-major table) and K8b
    (terrain(69), 9,522 tris, the field-major one) against their per-lane
    plain version, bitwise (t, row bits, u, v): closest, any-hit on
    segments just short of or past each closest hit, and a merged launch
    whose last 2 of 8 packets take the any-hit mode; at 128, 256 and 512
    threads and each leaf service; each launch counted on its kernel."""
    vb, rays8 = _v1_queue(grid, 4096, 13)
    assert vb.wide == (grid == 30)
    modes = [m for m in _k8_modes(vb, rays8, _short_of_hits(vb, rays8))
             if m[0].startswith(mode)]
    before = (tv.launches_k8a, tv.launches_k8b)
    _assert_modes_equal_plain(modes)
    assert (tv.launches_k8a, tv.launches_k8b) == (
        before[0] + vb.wide * len(modes), before[1] + (not vb.wide) * len(modes))
    k = modes[0][1]()
    assert k.shape == ((4, 4096) if vb.wide else (4096, 4))
    if mode == "anyhit":
        k = tv.launch(vb, rays8 if vb.wide else rays8.t().contiguous(), False)
    rows = _bits(k[1] if vb.wide else k[:, 1])
    assert (rows >= 0).any() and (rows < 0).any()


@pytest.mark.cuda
def test_k8b_tie_scene_on_card(monkeypatch):
    """On the tie scene flattened to world space, packed field-major (the
    row-count threshold set to 0), every K8b mode at each block size and
    leaf service equals its per-lane plain version bitwise; the first
    visited triangle wins an exact-t tie, and the packet walk picks the same
    triangles and t (no grazing lane). The same for K8a on its row-major
    table (the threshold as it is)."""
    dev = _card()
    (v0, e1, e2), (ro, rd, tmax, otm) = tie_world()
    tb = bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=tv.LEAF, builder="sah")
    rays8, orays8 = _packed(ro, rd, tmax, dev), _packed(ro, rd, otm, dev)
    vb = tv.pack_v1(tb, dev)
    assert vb.wide
    _assert_modes_equal_plain(_k8_modes(vb, rays8, orays8))
    k, packet = tv.launch(vb, rays8, False), tv.plain(vb, rays8, False)
    assert torch.equal(_bits(k[0:2]), _bits(packet[0:2]))
    monkeypatch.setattr(tv, "WIDE_MAX_ROWS", 0)
    vb = tv.pack_v1(tb, dev)
    assert not vb.wide
    _assert_modes_equal_plain(_k8_modes(vb, rays8, orays8))
    k = tv.launch(vb, rays8.t().contiguous(), False)
    packet = tv.plain(vb, rays8.t().contiguous(), False)
    assert torch.equal(_bits(k[:, 0:2]), _bits(packet[:, 0:2]))
    hit = _bits(k[:, 1]) >= 0
    assert hit.any() and (k[hit, 0] == 5.0).all()


def _cornell_v1_queue(n, seed):
    """Cornell's v1 pack (one 128-row leaf, 32 real rows: the row-major
    table) on the card, and a packed (8, n) queue: the primary rays of a
    camera at the golden's eye, then incoherent rays inside the box, 20%
    of them dead."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.cornell_box()).flatten_world()
    vb = tv.pack_v1(bvh_mod.build_threaded_bvh(flat.v0, flat.e1, flat.e2,
                                               leaf_size=tv.LEAF, builder="sah"),
                    dev)
    rng = np.random.default_rng(seed)
    half = n // 2
    d = np.stack([rng.uniform(-0.5, 0.5, half), rng.uniform(-0.5, 0.5, half),
                  -np.ones(half)], -1)
    ro = np.concatenate([np.broadcast_to([0.0, 1.0, 3.2], (half, 3)),
                         rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9],
                                     (n - half, 3))]).astype(np.float32)
    rd = np.concatenate([d, rng.normal(size=(n - half, 3))]).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.2, 0.0, 2.0e32).astype(np.float32)
    return vb, _packed(ro, rd, tmax, dev)


@pytest.mark.cuda
def test_k8a_cornell_on_card():
    """K8a on cornell's one leaf (32 of its 128 rows real): every mode at
    each block size and leaf service bitwise its per-lane plain version, on
    coherent primaries (each warp's holders scan the leaf) and incoherent
    rays with dead lanes."""
    vb, rays8 = _cornell_v1_queue(4096, 25)
    assert vb.wide and vb.real_rows.tolist() == [32]
    _assert_modes_equal_plain(_k8_modes(vb, rays8, _short_of_hits(vb, rays8)))
    rows = _bits(tv.launch(vb, rays8, False)[1])
    assert (rows >= 0).float().mean() > 0.5 and (rows < 32).all()


def _leaf_counts(rows, ls, leaves, counts):
    """``rows`` ((R, 9), a copy) with the rows of leaf ``leaves[0]`` all
    equal to its first row (a count of 1), leaf ``leaves[1]``'s from row 5
    on equal to its row 4 (a count of 5), and, where ``leaves`` has a third,
    that leaf's padding replaced by copies of its last real row moved by
    1e-3 a step along x (a full leaf of distinct rows); ``counts`` are the
    leaves' real-row counts before."""
    rows = rows.clone()
    a, b = (int(x) * ls for x in leaves[:2])
    rows[a + 1:a + ls] = rows[a]
    rows[b + 5:b + ls] = rows[b + 4]
    if len(leaves) > 2:
        c, n = int(leaves[2]) * ls, int(counts[leaves[2]])
        steps = torch.arange(1, ls - n + 1, device=rows.device, dtype=rows.dtype)
        rows[c + n:c + ls] = rows[c + n - 1]
        rows[c + n:c + ls, 0] += 1e-3 * steps
    return rows


def _k1_modes(fb, rays, orays, scan_from):
    """(name, launch, plain) of K1 closest, any-hit and merged (the first
    2,048 lanes closest, the rest any-hit) on packed (8, n) operands, with
    the leaf service ``scan_from``."""
    merged = torch.cat([rays[:, :2048], orays[:, 2048:]], dim=1).contiguous()

    def k1(q, shadow_from):
        return tr._launch(fb, tuple(q[0:6]), q[6], q[7], shadow_from, scan_from)

    big = -(-rays.shape[1] // tr.BLOCK)
    return (
        (f"closest scan_from={scan_from}", lambda: k1(rays, big)[0],
         lambda: tuple(traverse.closest_hit_threaded(
             fb, Vec3(*rays[0:3]), Vec3(*rays[3:6]), rays[6], rays[7]))),
        (f"any-hit scan_from={scan_from}", lambda: k1(orays, 0)[1],
         lambda: traverse.occluded_threaded(
             fb, Vec3(*orays[0:3]), Vec3(*orays[3:6]), orays[6], orays[7])),
        (f"merged scan_from={scan_from}",
         lambda: _flat(k1(merged, 2048 // tr.BLOCK)),
         lambda: _flat(tr.merged_plain(fb, merged, 2048))),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_size", [32, 64, 128])
def test_k1_leaf_services_on_card(leaf_size):
    """K1 closest, any-hit and merged equal the plain walk bitwise at leaf
    32, 64 and 128, with each leaf served by the warp (scan_from 33), by its
    holders alone (1) and by the default rule, on a ragged queue (4,000
    lanes) with dead lanes, an all-dead warp and empty segments; then on the
    same table with leaves of 1, 5 and all their real rows beside partial
    ones. Each launch is counted."""
    dev = _card()
    flat = Scene.from_vkr_scene(procedural.terrain(grid=24)).flatten_world()
    fb = _flat_pack(flat.v0, flat.e1, flat.e2, leaf_size, dev)
    rays, orays = _edge_rays(flat.v0.min(0), flat.v0.max(0), 4000, 24, dev)
    before = tr.launches
    for scan_from in (33, 1, None):
        _assert_modes_equal_plain(_k1_modes(fb, rays, orays, scan_from))
    assert tr.launches - before == 9
    hit = tr._launch(fb, tuple(rays[0:6]), rays[6], rays[7], 32)[0]
    empty = rays[7] <= rays[6]
    assert (hit[1][empty] == -1).all() and (hit[1][~empty] >= 0).any()
    partial = torch.nonzero((fb.real_rows > 5) & (fb.real_rows < leaf_size))[:, 0]
    rows = _leaf_counts(fb.tri_rows, leaf_size, partial[:3], fb.real_rows)
    cut = fb._replace(tri_rows=rows,
                      real_rows=traverse.real_row_counts(rows, leaf_size))
    assert cut.real_rows[partial[0]] == 1 and cut.real_rows[partial[1]] == 5
    assert cut.real_rows[partial[2]] == leaf_size
    for scan_from in (33, 1):
        _assert_modes_equal_plain(_k1_modes(cut, rays, orays, scan_from))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [30, 69])
def test_k8_real_row_counts_on_card(grid):
    """K8a (terrain(30), the row-major table) and K8b (terrain(69), the
    field-major one) on a table whose leaves hold 1, 5 and all 128 real rows
    beside the terrain's partial ones: every mode at each block size and
    leaf service bitwise the per-lane plain version."""
    vb, rays8 = _v1_queue(grid, 4096, 26)
    rows = vb.tris[:, 0:9] if vb.wide else vb.tris[0:9].t()
    partial = torch.nonzero(vb.real_rows > 5)[:, 0]
    cut = _leaf_counts(rows, tv.LEAF, partial[:3], vb.real_rows)
    tris = vb.tris.clone()
    if vb.wide:
        tris[:, 0:9] = cut
    else:
        tris[0:9] = cut.t()
    vc = vb._replace(tris=tris, real_rows=traverse.real_row_counts(cut, tv.LEAF))
    counts = vc.real_rows.tolist()
    assert 1 in counts and 5 in counts and tv.LEAF in counts
    assert any(0 < c < tv.LEAF and c not in (1, 5) for c in counts)
    _assert_modes_equal_plain(_k8_modes(vc, rays8, _short_of_hits(vc, rays8)))


@pytest.mark.cuda
def test_k8b_alignment_on_card():
    """K8b reads its table and rays in 16-byte loads, K8a its table: a
    table or ray operand that is not 16-byte aligned raises before any
    launch."""
    vb, rays8 = _v1_queue(69, 1024, 19)
    rays = rays8.t().contiguous()
    before = tv.launches_k8b
    off = torch.empty(vb.tris.numel() + 1, device=vb.tris.device)[1:]
    shifted = off.view(vb.tris.shape).copy_(vb.tris)
    with pytest.raises(ValueError, match="tris: its data must be 16-byte"):
        tv.launch(vb._replace(tris=shifted), rays, False)
    off = torch.empty(rays.numel() + 2, device=rays.device)[2:]
    with pytest.raises(ValueError, match="rays: its data must be 16-byte"):
        tv.launch(vb, off.view(rays.shape).copy_(rays), False)
    assert tv.launches_k8b == before
    va, rays8 = _v1_queue(30, 1024, 19)
    assert va.wide
    before = tv.launches_k8a
    off = torch.empty(va.tris.numel() + 1, device=va.tris.device)[1:]
    shifted = off.view(va.tris.shape).copy_(va.tris)
    with pytest.raises(ValueError, match="tris: its data must be 16-byte"):
        tv.launch(va._replace(tris=shifted), rays8, False)
    assert tv.launches_k8a == before


@pytest.mark.cuda
def test_k8_wrappers_on_card():
    """The wrappers on the card: the merged wrapper equals the closest and
    occluded wrappers bitwise on queues that are not whole packets and
    counts one merged launch; ``map_tri`` maps rows to source triangles."""
    for grid in (30, 69):
        vb, q = _v1_queue(grid, 2500, 14)
        cc, cs = tuple(q[0:6, :1500]), tuple(q[0:6, 1500:])
        args = (cc, q[6, :1500], q[7, :1500], cs, q[6, 1500:], q[7, 1500:])
        merged = tv.merged_launches
        hit, blocked = tv.closest_and_occluded_v1(vb, *args, map_tri=False)
        assert tv.merged_launches == merged + 1
        sep = tv.closest_hit_v1(vb, Vec3(*q[0:3, :1500]), Vec3(*q[3:6, :1500]),
                                *args[1:3], map_tri=False)
        sep_b = tv.occluded_v1(vb, Vec3(*q[0:3, 1500:]), Vec3(*q[3:6, 1500:]),
                               *args[4:6])
        for a, b in zip(hit, sep):
            assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(blocked, sep_b)
        mapped = tv.closest_hit_v1(vb, Vec3(*q[0:3, :1500]), Vec3(*q[3:6, :1500]),
                                   *args[1:3])
        assert torch.equal(mapped.tri, traverse.map_rows_to_tris(vb, sep).tri)


@pytest.mark.cuda
def test_cuda_tensor_with_broken_build_raises(tmp_path, monkeypatch):
    """No fallback: with a source that does not compile, a CUDA tensor's
    wrapper raises nvcc's error instead of running the plain version."""
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    vb, q = _v1_queue(8, 600, 15)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / f"{tv.KERNEL}.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    plain_calls = []
    for name in ("plain", "plain_lanes"):
        monkeypatch.setattr(tv, name, lambda *a: plain_calls.append(a))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tv.closest_hit_v1(vb, Vec3(*q[0:3]), Vec3(*q[3:6]), q[6], q[7])
    assert not plain_calls


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["always", "never"])
@pytest.mark.parametrize("variant", [1, 2, 3])  # BN, SOBOL, Z_SBL
def test_rng_draws_on_card_equal_cpu(variant, tables):
    """The Sobol, Z-Sobol and blue-noise states and draws on the card
    bitwise the CPU's (torch's int64 and f32 ops on CUDA tensors), the
    byte-table fold included, at dims 0-40 and 1016-1031 (past the
    reference matrix's 1,024 dims, which wrap)."""
    from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
    from realtimepathtracingresearchframework_tpu_torch.ops import sobol

    dev = _card()
    rng = np.random.default_rng(variant)
    px = torch.from_numpy(rng.integers(0, 1920, 65536).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, 1080, 65536).astype(np.int32))
    bufs = {d: pointsets.build_rng_buffers(variant, tables, device=d)
            for d in ("cpu", dev)}
    states = {d: pointsets.make_state(variant, 7, 3, px.to(d), py.to(d), 1920,
                                      bufs=bufs[d]) for d in bufs}
    for a, b in zip(*states.values()):
        assert torch.equal(a, b.cpu())
    for dim in list(range(41)) + list(range(1016, 1032)):
        out = {}
        for d in bufs:
            states[d], out[d] = pointsets.draw1(variant, bufs[d], states[d], dim)
        assert torch.equal(out["cpu"], out[dev].cpu()), dim
    idx = torch.from_numpy(rng.integers(0, 2**32, 65536, dtype=np.uint64)
                           .astype(np.int64))
    tables_cpu = bufs["cpu"].fold
    n = tables_cpu.shape[0]  # 1 (a dummy) for BN with the reference's tables
    for dim in sorted({0, 1, n - 2, n - 1} & set(range(n))):
        want = sobol.fold(tables_cpu[dim], idx)
        assert torch.equal(sobol.fold(bufs[dev].fold[dim], idx.to(dev)).cpu(), want)
        assert torch.equal(want, sobol.sobol_value(bufs["cpu"].matrices, idx, dim))


@pytest.mark.cuda
def test_refit_streamed_on_card():
    """refit_streamed uploaded to the card: at rest (the pack's own
    vertices) its tiles, nodes, top tree and rows equal the fresh pack's
    and each leaf's real-row count read from the tiles equals the fresh
    pack's; on moved vertices it equals the CPU upload of the same refit,
    and K4 on it equals its plain version over the CPU refit."""
    dev = _card()
    scene = Scene.from_vkr_scene(procedural.instanced_field(num_inst=60, frames=4))
    f0, f3 = scene.flatten_world(frame=0), scene.flatten_world(frame=3)
    bb, topo = ts.pack_streamed(f0.v0, f0.e1, f0.e2, with_topology=True,
                                device=dev)
    rest = ts.refit_streamed(topo, f0.v0, f0.e1, f0.e2, device=dev)
    for name in ("top_nodes", "sub_nodes", "tri_tiles", "row_tri"):
        assert torch.equal(getattr(rest, name), getattr(bb, name)), name
    assert torch.equal(traverse.real_row_counts(ts.leaf_rows(rest), ts.LEAF),
                       traverse.real_row_counts(ts.leaf_rows(bb), ts.LEAF))
    moved = ts.refit_streamed(topo, f3.v0, f3.e1, f3.e2, device=dev)
    cpu = ts.refit_streamed(topo, f3.v0, f3.e1, f3.e2)
    for name in ("top_nodes", "sub_nodes", "tri_tiles", "row_tri"):
        assert torch.equal(getattr(moved, name).cpu(), getattr(cpu, name)), name
    rays = _queue_over(f3, 16384, 11, dev)
    k = ts.launch(moved, rays, False)
    for a, b in zip(k, ts.plain(cpu, rays.cpu(), False)):
        assert torch.equal(a.cpu(), b)
    assert (k[1] >= 0).any()
