"""The port's two-level instancing (K6, K7) against the JAX package's.

- **Host builders and packs.** ``tlas.build_blas_set``,
  ``instance_world_aabbs``, ``build_tlas_nodes`` and
  ``build_instance_tables``, K6's ``pack_blas`` / ``pack_two_level`` and K7's
  ``pack_tlas_stream_static`` / ``pack_tlas_stream_frame`` equal the
  reference's arrays bit for bit on three scenes: the instanced scene of
  tests/test_traverse_kernels.py:389 (iso and anisotropic instances) and the
  multi-chunk scene of tests/test_tlas_stream.py:40 (12 instances,
  anisotropic, chunks of 512 triangles). K7's entry count is known from the
  mesh sizes alone (``chunk_count``).
- **Nested walk** (``tlas.closest_hit_two_level`` / ``occluded_two_level``,
  the CPU oracle) against the reference's XLA walk: triangles and instances
  exact, t of the hits within 1e-5 relative (the reference's Möller-Trumbore
  sums in another order; on a miss it returns the segment end, the port
  2e32 as the kernels do), blocked flags exact.
- **Plain K6 and K7** against the reference kernels in Pallas interpret
  mode: rows, instances and flags exact, t within 1e-5 relative, u and v
  within 1e-4 absolute (XLA contracts some multiply-adds into FMAs and the
  port does not; as for K1-K5). Their queues hold dead lanes (tmax = 0) and
  bounded tmax. Across kernels plain K6 = plain K7 = the nested walk:
  triangles and instances equal except on exact-t ties (none on these
  queues), t bitwise.
- **Past the entry cap.** The reference's K7 cap of 2,048 entries is its
  SMEM entry table; lowered under a scene's entry count, the reference
  renderer falls back to its XLA walk and the port stays on K7, with the
  same rays and image; K7's rows are held to int32. K6's ordered instance
  walk (plain) against the reference's ``ordered=True`` in interpret mode.
- **Renderer.** ``instanced_field(num_inst=6, frames=4)`` at 32x32, depth
  3, two animated frames, through the K6 route and the K7 route (forced by
  setting K6's ``MAX_INSTANCES`` to 0, as the reference's tests do) against
  the JAX renderer (its XLA walk on the CPU): ray counts exact, first-hit
  triangles and instances exact, radiance within ``goldens.compare_ref``'s
  1% / 1e-4. ``set_animation_frame(f)`` renders bitwise what a fresh
  ``set_scene(frame=f)`` renders and keeps the BLAS tensors.
  ``options.use_tlas`` reaches the two-level route (the port used to ignore
  it and flatten the scene). The wavefront executor, forced on that route,
  renders the animated frames bitwise as the monolith does and is dropped by
  ``set_animation_frame``.

The CUDA kernels are held to these plain versions bitwise on the card by
``chip_smoke.py`` and tests/test_torch_cuda.py.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.ops import tlas as jtlas
from realtimepathtracingresearchframework_tpu.ops import traverse_stream as jts
from realtimepathtracingresearchframework_tpu.ops import traverse_tlas as jtt
from realtimepathtracingresearchframework_tpu.ops import traverse_tlas_stream as jtts
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import tlas
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas as tt
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_tlas_stream as tts,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    pack_rays,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_tlas_stream import _rand_mesh, _rot  # noqa: E402
from test_torch_cuda import tie_scene  # noqa: E402
from test_traverse_kernels import _terrain  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

N_RAYS = 512
SIZE, DEPTH, FRAMES = 32, 3, 2
SCENES = ("iso", "aniso", "stream")


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _instances(name):
    """(meshes, mesh ids, (I, 3, 4) transforms, chunk size) of a scene:
    "iso" and "aniso" as tests/test_traverse_kernels.py:389-436 builds
    them (a 242-tri terrain and a 23-tri fan, 9 rotated, scaled and
    translated instances, per-axis scales for "aniso"); "stream" as
    tests/test_tlas_stream.py:40-70 with 12 instances of meshes of 2,300 and
    150 tris, anisotropic, in chunks of 512."""
    rng = np.random.default_rng({"iso": 11, "aniso": 12, "stream": 13}[name])
    if name == "stream":
        meshes = [_rand_mesh(rng, n) for n in (2300, 150)]
        mesh_ids = np.array([i % 2 for i in range(12)], np.int32)
        xfs = []
        for i in range(12):
            A = _rot(rng) * rng.uniform(0.5, 2.0)
            if i % 3 == 0:
                A = A @ np.diag(rng.uniform(0.4, 2.5, 3))
            t = rng.uniform(-6, 6, 3)
            xfs.append(np.concatenate([A, t[:, None]], axis=1))
        return meshes, mesh_ids, np.stack(xfs).astype(np.float32), 512
    th = np.linspace(0, 2 * np.pi, 24, dtype=np.float32)
    ring = np.stack([np.cos(th), np.sin(th), 0 * th], axis=-1)
    fan = np.stack([ring[:-1], ring[1:], np.zeros_like(ring[:-1])],
                   axis=1).astype(np.float32)
    meshes = [_terrain(12), (fan[:, 0], fan[:, 1] - fan[:, 0], fan[:, 2] - fan[:, 0])]
    mesh_ids = np.array([i % 2 for i in range(9)], np.int32)
    xfs = np.zeros((9, 3, 4), np.float32)
    for i in range(9):
        ang = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        if name == "aniso":
            xfs[i, :, :3] = rot @ np.diag(rng.uniform(0.3, 3.0, 3).astype(np.float32))
        else:
            xfs[i, :, :3] = rot * rng.uniform(0.5, 2.0)
        xfs[i, :, 3] = rng.uniform(-8, 8, 3).astype(np.float32)
    return meshes, mesh_ids, xfs, None


def _build(name):
    """The scene's meshes and instances, and both packages' builds of it."""
    return _build_from(*_instances(name))


def _build_from(meshes, mesh_ids, xfs, chunk):
    """Both packages' builds of a scene: meshes, mesh ids, transforms and
    K7's chunk size (None: picked from the meshes)."""
    mats = np.zeros(len(mesh_ids), np.int32)
    jblas = jtlas.build_blas_set(meshes)
    jnodes, jrow = jtlas.build_tlas_nodes(jtlas.instance_world_aabbs(jblas, mesh_ids, xfs))
    jtables = jtlas.build_instance_tables(jblas, mesh_ids, mats, xfs)
    jtb = jtlas.TwoLevelBuffers(
        tlas_nodes=jnp.asarray(jnodes), tlas_row_inst=jnp.asarray(jrow),
        blas_nodes=jnp.asarray(jblas.nodes), blas_tri_rows=jnp.asarray(jblas.tri_rows),
        blas_row_tri=jnp.asarray(jblas.row_tri), **jtables)
    jst6 = jtt.pack_blas_pallas(meshes)
    jbb6 = jtt.pack_two_level_pallas(jst6, mesh_ids, jblas.tri_base, jnodes, jrow, jtables)
    jst7 = jtts.pack_tlas_stream_static(meshes, chunk_tris=chunk)
    jfr = jtts.pack_tlas_stream_frame(jst7, mesh_ids, xfs, jblas.tri_base)

    blas = tlas.build_blas_set(meshes)
    aabbs = tlas.instance_world_aabbs(blas, mesh_ids, xfs)
    nodes, row = tlas.build_tlas_nodes(aabbs)
    tables = tlas.build_instance_tables(blas, mesh_ids, mats, xfs)
    st6 = tt.pack_blas(meshes)
    st7 = tts.pack_tlas_stream_static(meshes, chunk_tris=chunk)
    return dict(
        meshes=meshes, mesh_ids=mesh_ids, xfs=xfs, chunk=chunk,
        jax=dict(blas=jblas, nodes=jnodes, row=jrow, tables=jtables, tb=jtb,
                 st6=jst6, bb6=jbb6, st7=jst7, fr=jfr),
        blas=blas, aabbs=aabbs, nodes=nodes, row=row, tables=tables,
        tb=tlas.two_level_buffers(tlas.blas_tensors(blas), nodes, row, tables),
        st6=st6,
        bb6=tt.pack_two_level(st6, mesh_ids, blas.tri_base, nodes, row,
                              tables["inst_inv"].numpy(),
                              tables["inst_cull_scale"].numpy()),
        st7=st7, fr=tts.pack_tlas_stream_frame(st7, mesh_ids, xfs, blas.tri_base),
    )


def _queue(sc, seed):
    """N_RAYS rays aimed near the instances' centres from a box around
    them, with 1 in 7 lanes dead (tmax = 0) and 1 in 5 bounded (tmax in
    [0.5, 30)); and any-hit segments just short of or past each closest hit
    of the nested walk."""
    rng = np.random.default_rng(seed)
    centres = sc["aabbs"].mean(axis=1)
    target = centres[rng.integers(0, len(centres), N_RAYS)]
    target = target + rng.normal(scale=1.0, size=target.shape)
    ro = rng.uniform(-14, 14, (N_RAYS, 3)).astype(np.float32)
    rd = (target - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmax = np.full(N_RAYS, 2.0e32, np.float32)
    tmax[::5] = rng.uniform(0.5, 30.0, len(tmax[::5]))
    tmax[::7] = 0.0
    return ro, rd.astype(np.float32), tmax


def _soa(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Vec3(*(t[:, k].contiguous() for k in range(3)))


@pytest.fixture(scope="module")
def scenes():
    return {name: _build(name) for name in SCENES}


@pytest.fixture(scope="module")
def queues(scenes):
    """Per scene: the queue, the nested walk's closest hits on it, and the
    any-hit segments built from them."""
    out = {}
    for i, (name, sc) in enumerate(scenes.items()):
        ro, rd, tmax = _queue(sc, 100 + i)
        hit = tlas.closest_hit_two_level(sc["tb"], _soa(ro), _soa(rd), 0.0,
                                         torch.from_numpy(tmax))
        rng = np.random.default_rng(200 + i)
        scale = np.where(rng.uniform(size=N_RAYS) < 0.5, 0.999, 1.001)
        otm = np.where(hit.tri.numpy() >= 0, hit.t.numpy() * scale, 30.0)
        otm = np.where(tmax > 0, otm, 0.0).astype(np.float32)
        out[name] = dict(ro=ro, rd=rd, tmax=tmax, otm=otm, nested=hit)
    return out


def _jq(q):
    return (jnp.asarray(q["ro"]), jnp.asarray(q["rd"]), jnp.asarray(q["tmax"]),
            jnp.asarray(q["otm"]))


@pytest.fixture(scope="module")
def oracles(scenes, queues):
    """One call of each reference function per scene it is held to here:
    the XLA nested walk, and K6 / K7 in interpret mode."""
    jtt.INTERPRET = jtts.INTERPRET = True
    try:
        out = {}
        for name in ("iso", "stream"):
            jtb = scenes[name]["jax"]["tb"]
            ro, rd, tm, otm = _jq(queues[name])
            out[name, "xla"] = jtlas.closest_hit_two_level(jtb, ro, rd, 0.0, tm)
            out[name, "xla_occ"] = jtlas.occluded_two_level(jtb, ro, rd, 0.0, otm)
        for name in ("iso", "aniso"):
            jbb6 = scenes[name]["jax"]["bb6"]
            ro, rd, tm, otm = _jq(queues[name])
            out[name, "k6"] = jtt.closest_hit_tlas_pallas(jbb6, ro, rd, 0.0, tm,
                                                          block=256)
            out[name, "k6_occ"] = jtt.occluded_tlas_pallas(jbb6, ro, rd, 0.0, otm,
                                                           block=256)
        jbb6 = scenes["aniso"]["jax"]["bb6"]
        ro, rd, tm, _ = _jq(queues["aniso"])
        out["aniso", "k6_ordered"] = jtt.closest_hit_tlas_pallas(
            jbb6, ro, rd, 0.0, tm, block=256, ordered=True)
        j = scenes["stream"]["jax"]
        ro, rd, tm, otm = _jq(queues["stream"])
        out["stream", "k7"] = jtts.closest_hit_tlas_stream(
            j["st7"], j["fr"], ro, rd, 0.0, tm, sort=True)
        out["stream", "k7_occ"] = jtts.occluded_tlas_stream(
            j["st7"], j["fr"], ro, rd, 0.0, otm)
        return out
    finally:
        jtt.INTERPRET = jtts.INTERPRET = False


def _assert_hit_close(hit, ref):
    """Triangles, instances exact; t within 1e-5 relative; u, v within 1e-4
    absolute (see the module docstring)."""
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(hit.inst.numpy(), np.asarray(ref.inst))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=0)
    for p, r in ((hit.u, ref.u), (hit.v, ref.v)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Host builders and packs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SCENES)
def test_builders_and_packs_match_reference(scenes, name):
    sc = scenes[name]
    j = sc["jax"]
    for field in j["blas"]._fields:
        np.testing.assert_array_equal(_bits(getattr(sc["blas"], field)),
                                      _bits(getattr(j["blas"], field)), field)
    np.testing.assert_array_equal(
        _bits(sc["aabbs"]),
        _bits(jtlas.instance_world_aabbs(j["blas"], sc["mesh_ids"], sc["xfs"])))
    np.testing.assert_array_equal(_bits(sc["nodes"]), _bits(j["nodes"]))
    np.testing.assert_array_equal(sc["row"], np.asarray(j["row"]))
    for key, value in j["tables"].items():
        np.testing.assert_array_equal(_bits(sc["tables"][key].numpy()), _bits(value), key)
    for field in j["st6"]._fields:
        np.testing.assert_array_equal(_bits(getattr(sc["st6"], field)),
                                      _bits(getattr(j["st6"], field)), field)
    for field in j["bb6"]._fields:
        np.testing.assert_array_equal(_bits(getattr(sc["bb6"], field)),
                                      _bits(getattr(j["bb6"], field)), field)
    assert sc["bb6"].blas_nodes is sc["st6"].blas_nodes  # not copied per frame
    for field in j["st7"]._fields:
        np.testing.assert_array_equal(_bits(getattr(sc["st7"], field)),
                                      _bits(getattr(j["st7"], field)), field)
    for field in j["fr"]._fields:
        np.testing.assert_array_equal(_bits(getattr(sc["fr"], field)),
                                      _bits(getattr(j["fr"], field)), field)
    sizes = [len(m[0]) for m in sc["meshes"]]
    assert tts.entry_count(sizes, sc["mesh_ids"], sc["st7"].chunk_tris) == \
        sc["fr"].num_entries
    if name == "stream":
        assert sc["st7"].num_chunks > len(sizes)  # multi-chunk meshes


def test_chunk_count_and_pick_chunk_tris():
    """The entry count comes from the mesh sizes: ``chunk_count`` equals
    the number of chunks ``_split_chunks`` makes; ``pick_chunk_tris`` of a
    list of mesh sizes equals the reference's."""
    rng = np.random.default_rng(3)
    for n in (1, 127, 512, 513, 1024, 2047, 2300, 5000, 9000, 17_000):
        cent = rng.uniform(size=(n, 3)).astype(np.float32)
        for chunk in (512, 1024, 2048):
            assert tts.chunk_count(n, chunk) == len(jts._split_chunks(cent, chunk))
    for sizes in ([2], [2048, 544, 30, 2], [9000, 3], [100_000], []):
        assert tts.pick_chunk_tris(sizes) == jtts.pick_chunk_tris(sizes)
    assert tts.pick_chunk_tris([2048, 544, 30, 2]) == 2048


# ---------------------------------------------------------------------------
# The nested walk, K6, K7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["iso", "stream"])
def test_nested_walk_matches_reference(scenes, queues, oracles, name):
    q = queues[name]
    assert 0.2 < (q["nested"].tri >= 0).float().mean() < 0.9
    hit = q["nested"]
    ref = oracles[name, "xla"]
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(hit.inst.numpy(), np.asarray(ref.inst))
    # on a miss the reference returns the segment end, the port T_MAX
    found = hit.tri.numpy() >= 0
    np.testing.assert_allclose(hit.t.numpy()[found], np.asarray(ref.t)[found],
                               rtol=1e-5, atol=0)
    assert (hit.t.numpy()[~found] == 2.0e32).all()
    blocked = tlas.occluded_two_level(scenes[name]["tb"], _soa(q["ro"]),
                                      _soa(q["rd"]), 0.0, torch.from_numpy(q["otm"]))
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(oracles[name, "xla_occ"]))
    assert blocked.any() and not blocked.all()


@pytest.mark.parametrize("name", ["iso", "aniso"])
def test_plain_k6_matches_reference(scenes, queues, oracles, name):
    sc, q = scenes[name], queues[name]
    o, d = _soa(q["ro"]), _soa(q["rd"])
    hit = tt.closest_hit_tlas(sc["bb6"], o, d, 0.0, torch.from_numpy(q["tmax"]))
    _assert_hit_close(hit, oracles[name, "k6"])
    assert (hit.tri[::7] == -1).all() and (hit.t[::7] == 2.0e32).all()
    blocked = tt.occluded_tlas(sc["bb6"], o, d, 0.0, torch.from_numpy(q["otm"]))
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(oracles[name, "k6_occ"]))


def test_plain_k6_ordered_matches_reference(scenes, queues, oracles):
    """K6's ordered instance walk (plain) against the reference's
    ``ordered=True`` in interpret mode (tests/test_traverse_kernels.py:
    439-471), and against the preorder walk: t bitwise, triangles and
    instances equal (no exact-t tie on this queue)."""
    sc, q = scenes["aniso"], queues["aniso"]
    o, d = _soa(q["ro"]), _soa(q["rd"])
    tm = torch.from_numpy(q["tmax"])
    hit = tt.closest_hit_tlas(sc["bb6"], o, d, 0.0, tm, ordered=True)
    _assert_hit_close(hit, oracles["aniso", "k6_ordered"])
    pre = tt.closest_hit_tlas(sc["bb6"], o, d, 0.0, tm)
    assert torch.equal(hit.t, pre.t)
    assert torch.equal(hit.tri, pre.tri) and torch.equal(hit.inst, pre.inst)
    rays, _ = pack_rays(o, d, 0.0, tm, 512)
    with pytest.raises(AssertionError, match="closest-hit"):
        tt.plain(sc["bb6"], rays, True, ordered=True)


def test_plain_k7_matches_reference(scenes, queues, oracles):
    sc, q = scenes["stream"], queues["stream"]
    o, d = _soa(q["ro"]), _soa(q["rd"])
    tm = torch.from_numpy(q["tmax"])
    hits = [tts.closest_hit_tlas_stream(sc["st7"], sc["fr"], o, d, 0.0, tm, sort=s)
            for s in (False, True)]
    for a, b in zip(*hits):
        assert torch.equal(a, b)  # the sort is invisible in the result
    _assert_hit_close(hits[1], oracles["stream", "k7"])
    otm = torch.from_numpy(q["otm"])
    blocked = [tts.occluded_tlas_stream(sc["st7"], sc["fr"], o, d, 0.0, otm, sort=s)
               for s in (False, True)]
    assert torch.equal(blocked[0], blocked[1])
    np.testing.assert_array_equal(blocked[0].numpy(),
                                  np.asarray(oracles["stream", "k7_occ"]))


@pytest.mark.parametrize("name", SCENES)
def test_plain_k6_k7_and_nested_walk_agree(scenes, queues, name):
    """Across kernels: triangles and instances equal except on exact-t ties
    (counted; none on these queues), t bitwise equal everywhere; blocked
    flags equal."""
    sc, q = scenes[name], queues[name]
    o, d = _soa(q["ro"]), _soa(q["rd"])
    tm, otm = torch.from_numpy(q["tmax"]), torch.from_numpy(q["otm"])
    h6 = tt.closest_hit_tlas(sc["bb6"], o, d, 0.0, tm)
    h7 = tts.closest_hit_tlas_stream(sc["st7"], sc["fr"], o, d, 0.0, tm)
    hn = q["nested"]
    ties = 0
    for a, b in ((h6, hn), (h7, hn), (h6, h7)):
        assert torch.equal(a.t, b.t)
        ties += int(((a.tri != b.tri) | (a.inst != b.inst)).sum())
    assert ties == 0
    b6 = tt.occluded_tlas(sc["bb6"], o, d, 0.0, otm)
    b7 = tts.occluded_tlas_stream(sc["st7"], sc["fr"], o, d, 0.0, otm)
    bn = tlas.occluded_two_level(sc["tb"], o, d, 0.0, otm)
    assert torch.equal(b6, bn) and torch.equal(b7, bn)


def test_kernel_outputs_decode(scenes, queues):
    """Raw rows: K6's are (tile_base + leaf) * 128 + k with the instance
    beside them, K7's entry * chunk_tris + chunk row; both decode to the
    same global shading rows. Padding lanes of the packed operand miss."""
    sc, q = scenes["stream"], queues["stream"]
    o, d = _soa(q["ro"][:300]), _soa(q["rd"][:300])
    rays, n = pack_rays(o, d, 0.0, 2.0e32, 256)
    assert rays.shape[1] == 512 and n == 300
    t6, row6, _, _, inst6 = tt.traverse_rays(sc["bb6"], rays, False)
    t7, row7, _, _ = tts.traverse_rays(sc["st7"], sc["fr"], rays, False)
    assert (row6[n:] == -1).all() and (row7[n:] == -1).all()
    assert torch.equal(row6 < 0, inst6 < 0)
    entry = torch.clamp(row7, min=0) // sc["st7"].chunk_tris
    inst7 = torch.where(row7 < 0, -1, sc["fr"].entry_inst[entry.long()])
    assert torch.equal(inst6, inst7)
    h6 = tt.out_to_hit(sc["bb6"], (t6, row6, t6, t6, inst6), n)
    h7 = tts.out_to_hit(sc["st7"], sc["fr"], (t7, row7, t7, t7), n)
    assert torch.equal(h6.tri, h7.tri) and (h6.tri >= 0).any()


@pytest.fixture(scope="module")
def ties():
    """The tie scene (tests/test_torch_cuda.py::tie_scene): both packages'
    builds, the port's packed queues, and each reference function held to
    it, once, K6 and K7 in interpret mode."""
    meshes, mesh_ids, xfs, ro, rd, tmax, otm = tie_scene()
    sc = _build_from(meshes, mesh_ids, xfs, None)
    j = sc["jax"]
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)
    jtm, jotm = jnp.asarray(tmax), jnp.asarray(otm)
    jtt.INTERPRET = jtts.INTERPRET = True
    try:
        ref = {
            "K6": jtt.closest_hit_tlas_pallas(j["bb6"], jro, jrd, 0.0, jtm,
                                              block=256),
            "K6 ordered": jtt.closest_hit_tlas_pallas(
                j["bb6"], jro, jrd, 0.0, jtm, block=256, ordered=True),
            "K6 any-hit": jtt.occluded_tlas_pallas(j["bb6"], jro, jrd, 0.0, jotm,
                                                   block=256),
            "K7": jtts.closest_hit_tlas_stream(j["st7"], j["fr"], jro, jrd, 0.0,
                                               jtm),
            "K7 any-hit": jtts.occluded_tlas_stream(j["st7"], j["fr"], jro, jrd,
                                                    0.0, jotm),
        }
    finally:
        jtt.INTERPRET = jtts.INTERPRET = False
    return dict(sc=sc, o=_soa(ro), d=_soa(rd), tmax=torch.from_numpy(tmax),
                otm=torch.from_numpy(otm), ref=ref)


def test_tie_scene_holds_ties(ties):
    """The tie scene is what it claims: each mesh's repeated triangle lies
    in the leaf of its original, two pairs of instances share a transform,
    and every hit is at t = 5 exactly."""
    sc = ties["sc"]
    bb = sc["bb6"]
    row_tri = bb.row_tri.numpy()
    for mesh, (orig, copy) in enumerate(((41, 288), (6, 32))):
        base = int(bb.inst_table[2 * mesh, 15]) * 128
        size = len(sc["meshes"][mesh][0])
        rows = row_tri[base:base + -(-size // 128) * 128]
        leaf = [int(np.flatnonzero(rows == k)[0]) // 128 for k in (orig, copy)]
        assert leaf[0] == leaf[1]
    table = bb.inst_table.numpy()
    assert (table[0] == table[1]).all() and (table[3] == table[4]).all()
    hit = tt.closest_hit_tlas(bb, ties["o"], ties["d"], 0.0, ties["tmax"])
    found = hit.tri >= 0
    assert 0.3 < found.float().mean() < 0.9 and (hit.t[found] == 5.0).all()


@pytest.mark.parametrize("mode", ["K6", "K6 ordered", "K6 any-hit", "K7",
                                  "K7 any-hit"])
def test_plain_two_level_on_ties_matches_reference(ties, mode):
    """Plain K6 (preorder and ordered) and plain K7 on the tie scene against
    the reference's kernels in interpret mode: the same triangle and
    instance win every exact-t tie (ids and flags exact, t within 1e-5
    relative, u and v within 1e-4 absolute, as above)."""
    sc, o, d, ref = ties["sc"], ties["o"], ties["d"], ties["ref"][mode]
    if mode == "K6 any-hit":
        blocked = tt.occluded_tlas(sc["bb6"], o, d, 0.0, ties["otm"])
    elif mode == "K7 any-hit":
        blocked = tts.occluded_tlas_stream(sc["st7"], sc["fr"], o, d, 0.0,
                                           ties["otm"])
    elif mode == "K7":
        _assert_hit_close(tts.closest_hit_tlas_stream(
            sc["st7"], sc["fr"], o, d, 0.0, ties["tmax"]), ref)
        return
    else:
        _assert_hit_close(tt.closest_hit_tlas(
            sc["bb6"], o, d, 0.0, ties["tmax"], ordered=mode == "K6 ordered"), ref)
        return
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref))
    assert blocked.any() and not blocked.all()


def test_top_placement_rule(scenes):
    """K6's TLAS and K7's top tree are staged in shared memory up to
    ``STAGE_MAX_BYTES`` and read from global memory past it; the launchers
    measure a tree as 32 bytes a node."""
    limit = tt.STAGE_MAX_BYTES
    for nbytes in (32, limit - 32, limit):
        assert tt.top_staged(nbytes)
    for nbytes in (limit + 32, 2 * limit, 5001 * 32):
        assert not tt.top_staged(nbytes)
    sc = scenes["stream"]
    assert tt.tlas_bytes(sc["bb6"]) == 32 * sc["bb6"].num_tlas_nodes
    assert tts.top_bytes(sc["fr"]) == 32 * sc["fr"].num_top_nodes


def test_two_level_operands_must_be_16_byte_aligned():
    """K6 and K7 read nodes and tiles in 16-byte loads: the launchers'
    operand check refuses a tensor whose data is not 16-byte aligned."""
    base = torch.zeros(36, dtype=torch.float32)
    tt.check_aligned(nodes=base[4:].view(4, 8))
    with pytest.raises(ValueError, match="nodes: its data must be 16-byte"):
        tt.check_aligned(nodes=base[1:33].view(4, 8))


# ---------------------------------------------------------------------------
# Integrator and renderer
# ---------------------------------------------------------------------------


SC = SceneConfig(sun_dir=(0.4, 0.8, 0.25), turbidity=3.0)
CAM = OrientedCamera.look_at([0, 14.0, 30.0], [0, 0, 0], fovy=55)


def _field(pkg):
    return (JaxScene if pkg == "jax" else Scene).from_vkr_scene(
        (jproc if pkg == "jax" else procedural).instanced_field(num_inst=6, frames=4))


def _port_render(route, monkeypatch=None, frames=FRAMES):
    """The port on the CPU: set_scene, then per frame set_animation_frame(f
    + 1) and one render. Returns (image, rays per frame, renderer, cfg)."""
    r = trend.Renderer(device="cpu")
    r.options = r.options.replace(use_tlas=True)
    r.initialize(SIZE, SIZE)
    old = tt.MAX_INSTANCES
    if route == "k7":
        tt.MAX_INSTANCES = 0
    try:
        r.set_scene(_field("port"), scene_config=SC)
    finally:
        tt.MAX_INSTANCES = old
    cfg = trend.FrameConfig(camera=CAM, params=RenderParams(
        batch_spp=1, max_path_depth=DEPTH), scene_config=SC)
    rays = []
    for f in range(frames):
        r.set_animation_frame(f + 1)
        r.render(cfg)
        rays.append(r.last_frame_rays())
    return r.readback_accumulation(), rays, r, cfg


@pytest.fixture(scope="module")
def renders():
    """The port's K6 and K7 routes and the JAX renderer (XLA nested walk)
    on the same animated frames."""
    out = {route: _port_render(route) for route in ("k6", "k7")}
    jr = jrend.Renderer()
    jr.options = jr.options.replace(use_tlas=True)
    jr.initialize(SIZE, SIZE)
    jr.set_scene(_field("jax"), scene_config=SC)
    jcfg = jrend.FrameConfig(camera=CAM, params=out["k6"][3].params,
                             scene_config=SC)
    jrays = []
    for f in range(FRAMES):
        jr.set_animation_frame(f + 1, SC)
        jr.render(jcfg)
        jrays.append(sum(int(x) for x in jr._last_rays))
    out["jax"] = (np.asarray(jr.readback_accumulation()), jrays, jr, jcfg)
    return out


@pytest.mark.parametrize("route", ["k6", "k7"])
def test_frame_matches_jax(renders, route):
    img, rays, r, _ = renders[route]
    assert r._route.tlas == route and r._wavefront is None
    cfg = r._integrator_config(RenderParams(max_path_depth=DEPTH))
    assert cfg.two_level and cfg.tlas_k6 == (route == "k6")
    assert cfg.tlas_stream == (route == "k7") and not cfg.compact
    jimg, jrays, _, _ = renders["jax"]
    assert rays == jrays
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 0.3 < img[..., 3].mean() < 1.0
    res = goldens.compare_ref(img[..., :3], jimg[..., :3].astype(np.float64))
    assert res["ok"], res


@pytest.mark.parametrize("route", ["k6", "k7"])
def test_first_hits_match_jax(renders, route):
    """The last frame's sample-0 primaries: the route's closest-hit dispatch
    against the reference's XLA walk on the same rays, triangle and
    instance for every pixel."""
    _, _, r, cfg = renders[route]
    _, _, jr, _ = renders["jax"]
    px, py, valid, *_ = ti.swizzle_host(SIZE, SIZE)
    basis = cfg.camera.view_basis(SIZE, SIZE)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    st = tps.make_state(0, 0, 0, tpx, tpy, SIZE)
    _, ro, rd = ti.camera_setup(
        ti.IntegratorConfig(), ti.ViewBuffers(*(torch.from_numpy(a) for a in basis)),
        tpx, tpy, (float(SIZE), float(SIZE)), st)
    icfg = r._integrator_config(cfg.params)
    hit = ti._closest_hit_dispatch(r.device_scene, icfg, ro, rd, 0.0, 2.0e32)
    ref = jtlas.closest_hit_two_level(
        jr.device_scene.tlas, jnp.stack([jnp.asarray(c.numpy()) for c in ro], -1),
        jnp.stack([jnp.asarray(c.numpy()) for c in rd], -1))
    np.testing.assert_array_equal(hit.tri.numpy()[valid], np.asarray(ref.tri)[valid])
    np.testing.assert_array_equal(hit.inst.numpy()[valid], np.asarray(ref.inst)[valid])
    assert len(set(hit.inst.numpy()[valid].tolist())) >= 4


@pytest.mark.parametrize("route", ["k6", "k7"])
def test_animation_frame_equals_fresh_scene(renders, route):
    """set_animation_frame(2) after set_scene renders bitwise what a fresh
    set_scene(frame=2) renders; the BLAS tensors stay the same objects and
    the TLAS side changes."""
    r = trend.Renderer(device="cpu")
    r.options = r.options.replace(use_tlas=True)
    r.initialize(SIZE, SIZE)
    old = tt.MAX_INSTANCES
    if route == "k7":
        tt.MAX_INSTANCES = 0
    try:
        r.set_scene(_field("port"), scene_config=SC)
        fresh = trend.Renderer(device="cpu")
        fresh.options = r.options
        fresh.initialize(SIZE, SIZE)
        fresh.set_scene(_field("port"), scene_config=SC, frame=2)
    finally:
        tt.MAX_INSTANCES = old
    ds0 = r.device_scene
    cfg = renders[route][3]
    r.render(cfg)
    r.set_animation_frame(2)
    assert r.frame_id == 0 and r.tlas_update_seconds > 0
    ds = r.device_scene
    if route == "k6":
        assert ds.tlas_k6.blas_nodes is ds0.tlas_k6.blas_nodes
        assert ds.tlas_k6.tri_tiles is ds0.tlas_k6.tri_tiles
        assert ds.tlas.blas_nodes is ds0.tlas.blas_nodes
        assert not torch.equal(ds.tlas_k6.inst_table, ds0.tlas_k6.inst_table)
    else:
        assert ds.tlas_stream[0] is ds0.tlas_stream[0]
        assert not torch.equal(ds.tlas_stream[1].entry_table,
                               ds0.tlas_stream[1].entry_table)
    assert ds.attr_packed is ds0.attr_packed
    r.render(cfg)
    fresh.render(cfg)
    assert r.last_frame_rays() == fresh.last_frame_rays()
    np.testing.assert_array_equal(r.readback_accumulation(),
                                  fresh.readback_accumulation())


def test_use_tlas_reaches_two_level_route():
    """``options.use_tlas=True`` takes the two-level route and reaches
    ``IntegratorConfig.two_level``; without it the same scene is flattened
    (the port used to flatten it either way)."""
    flat_r = trend.Renderer(device="cpu")
    flat_r.initialize(16, 16)
    flat_r.set_scene(_field("port"), scene_config=SC)
    assert not flat_r._integrator_config(RenderParams()).two_level
    assert flat_r.device_scene.tlas is None
    r = trend.Renderer(device="cpu")
    r.options = r.options.replace(use_tlas=True)
    r.initialize(16, 16)
    r.set_scene(_field("port"), scene_config=SC)
    cfg = r._integrator_config(RenderParams())
    assert cfg.two_level and cfg.tlas_k6 and not cfg.tlas_stream
    assert r.device_scene.bvh is None and r.device_scene.tlas_k6 is not None
    assert r.device_scene.attr_packed.shape[1] == sum(
        len(m[0]) for m in r._mesh_tris)  # object-space attribute rows
    before = tt.launches_k6
    r.render(trend.FrameConfig(camera=CAM, params=RenderParams(max_path_depth=2),
                               scene_config=SC))
    assert tt.launches_k6 == before  # the CPU runs the plain version


def test_two_level_limits(monkeypatch):
    """Past the reference's K7 cap of 2,048 entries (lowered here to 6) the
    port still takes K7 (the cap is the TPU's SMEM entry table); K7's rows
    must fit int32, else ``ValueError``; the same field flattened is
    animated by a BVH rebuild (within the rebuild budget); K6's ordered
    walk is a route of
    the integrator (``stream_closest="ordered"``); a two-level scene runs
    on K6 or K7, never on the nested walk."""
    monkeypatch.setattr(jtts, "MAX_ENTRIES", 6)
    monkeypatch.setattr(tt, "MAX_INSTANCES", 0)
    r = trend.Renderer(device="cpu")
    r.options = r.options.replace(use_tlas=True)
    r.initialize(16, 16)
    r.set_scene(_field("port"), scene_config=SC)
    assert r._route.tlas == "k7"
    assert r.device_scene.tlas_stream[1].num_entries > jtts.MAX_ENTRIES
    tts.check_rows(2**31 // 8192, 8192)
    with pytest.raises(ValueError, match="int32"):
        tts.check_rows(2**31 // 8192 + 1, 8192)
    flat_r = trend.Renderer(device="cpu")
    flat_r.initialize(16, 16)
    flat_r.set_scene(_field("port"), scene_config=SC)
    flat_r.set_animation_frame(1)
    assert flat_r.animation_update == "rebuild" and flat_r._scene_frame == 1
    assert flat_r.device_scene.tlas is None
    sc = _build("iso")
    o = _soa(np.tile(np.array([[0.0, 20.0, 0.5]], np.float32), (64, 1)))
    d = _soa(np.tile(np.array([[0.05, -1.0, 0.02]], np.float32), (64, 1)))
    ds = ti.DeviceScene(bvh=None, attr_packed=None, mat_packed=None, lights=None,
                        sky=None, tlas_k6=sc["bb6"])
    cfg = ti.IntegratorConfig(two_level=True, tlas_k6=True, stream_closest="ordered")
    hit = ti._closest_hit_dispatch(ds, cfg, o, d, 0.0, 2.0e32)
    pre = tt.closest_hit_tlas(sc["bb6"], o, d)
    assert torch.equal(hit.t, pre.t) and torch.equal(hit.tri, pre.tri)
    with pytest.raises(AssertionError, match="K6 or K7"):
        ti._occluded_dispatch(ds, ti.IntegratorConfig(two_level=True), o, d,
                              0.0, 2.0e32)


def test_past_entry_cap_matches_jax(renders, monkeypatch):
    """A two-level scene past the reference's K7 entry cap (lowered to 6,
    under instanced_field(6)'s 7 entries): the reference renderer, its
    two-level kernels forced on, falls back to its XLA walk
    (renderer.py:737-757), the port renders through K7; rays exact, the
    image within ``goldens.compare_ref``'s gate of the JAX renderer's."""
    monkeypatch.setenv("RPTR_FORCE_TLAS_PALLAS", "1")
    monkeypatch.setattr(jtt, "MAX_INSTANCES", 0)
    monkeypatch.setattr(jtts, "MAX_ENTRIES", 6)
    jr = jrend.Renderer()
    jr.options = jr.options.replace(use_tlas=True)
    jr.initialize(SIZE, SIZE)
    jr.set_scene(_field("jax"), scene_config=SC)
    assert jr._use_two_level and not jr._use_tlas_stream
    assert not jr._use_tlas_pallas
    img, rays, r, _ = renders["k7"]
    assert r.device_scene.tlas_stream[1].num_entries > jtts.MAX_ENTRIES
    jimg, jrays, _, _ = renders["jax"]  # the XLA walk, as jr would render
    assert rays == jrays
    res = goldens.compare_ref(img[..., :3], jimg[..., :3].astype(np.float64))
    assert res["ok"], res


@pytest.mark.parametrize("route", ["k6", "k7"])
def test_animated_wavefront_equals_monolith(renders, route, monkeypatch):
    """The bounce-major executor, forced on the two-level route
    (``RPTR_HOST_WAVEFRONT=1``), renders the animated frames bitwise as the
    monolithic pass does; ``set_animation_frame`` drops the executor, which
    holds the old frame's device scene (the reference keeps its programs
    there, renderer.py:1953, and renders frame 0's transforms)."""
    img, rays, _, cfg = renders[route]
    monkeypatch.setenv("RPTR_HOST_WAVEFRONT", "1")
    wimg, wrays, r, _ = _port_render(route)
    assert r._wavefront is not None
    assert wrays == rays
    np.testing.assert_array_equal(wimg, img)
    r.set_animation_frame(3)
    assert r._wavefront is None
