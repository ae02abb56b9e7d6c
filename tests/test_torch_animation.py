"""Animation of flattened scenes (``Renderer.set_animation_frame`` without
``options.use_tlas``; reference renderer.py:1963-2060) on the CPU.

- tests/test_animation.py:45-77 on the port: a single triangle moved +x by
  one unit per frame, found where it moved (a rebuild) and through the
  refit path (``rebuild_triangle_budget=0``), the ray queries equal to
  the JAX renderer's.
- ``procedural.instanced_field(num_inst=6, frames=4)`` flattened (4,732
  triangles) on the resident K1 route, the K2/K3 route
  (``RPTR_TRAVERSAL_V3=1``, whose wavefront executor is dropped) and the
  streamed route (``RPTR_FORCE_STREAMED_TRAVERSAL=1``, f32 tiles and
  16-bit quantized tiles), each refit (``rebuild_triangle_budget=0``) and
  rebuilt (``force_bvh_rebuild``), at animation frame 2: the closest-hit
  queries against the JAX renderer's at frame 2 (triangles exact and t to
  rtol 1e-4, except on the
  0.15-0.2% of rays that cross a triangle's edge, where XLA's fused edge
  test rounds otherwise; the quantized pack always repacks, so against the
  port's own quantized pack of frame 2, bitwise), the resident packs'
  real-row counts those of their rows' bits, and the flattened scene the
  lights are collected from that of the posed frame.
- ``traverse_stream.refit_streamed`` against the JAX package's on moved
  vertices (tiles, nodes, top tree and rows bitwise: both are host
  numpy), and at rest against ``pack_streamed``'s own pack, bitwise, with
  each leaf's real-row count read from the tiles' bits.
- One 32x32 frame of the flattened field after ``set_animation_frame(2)``
  against the JAX renderer's: rays exact, radiance at
  ``goldens.compare_ref``'s gate. LoD scenes are tests/test_torch_lod.py's.

The JAX renderer's frame-2 state is shared through a module fixture.
"""

import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.quantization import (
    quantize_transforms as jquant,
)
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.ops import traverse_stream as jts
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import (
    OrientedCamera,
)
from realtimepathtracingresearchframework_tpu_torch.models.quantization import (
    quantize_transforms,
)
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_stream as ts

torch.set_num_threads(1)  # see tests/test_torch_render.py

SC = SceneConfig(sun_dir=(0.4, 0.8, 0.25), turbidity=3.0)
CAM = OrientedCamera.look_at([0, 14.0, 30.0], [0, 0, 0], fovy=55)
SIZE, DEPTH, N = 32, 3, 2048
ROUTES = {
    "k1": {},
    "k2k3": {"RPTR_TRAVERSAL_V3": "1"},
    "streamed": {"RPTR_FORCE_STREAMED_TRAVERSAL": "1"},
    "quantized": {"RPTR_FORCE_STREAMED_TRAVERSAL": "1"},
}
ROUTE_ENV = ("RPTR_TRAVERSAL_V3", "RPTR_HOST_WAVEFRONT", "RPTR_COMPACT_LANES",
             "RPTR_TRAVERSAL_V1", "RPTR_FORCE_STREAMED_TRAVERSAL")


@pytest.fixture
def route_env(monkeypatch):
    for k in ROUTE_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _single_triangle(pkg_proc, quant, frames=3):
    """One triangle translated +x by 1 unit per frame
    (tests/test_animation.py:18-32)."""
    vs = pkg_proc.single_triangle()
    mats = []
    for f in range(frames):
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.eye(3)
        m[0, 3] = float(f)
        mats.append(m)
    vs.num_static_transforms = 0
    vs.num_animated_transforms = 1
    vs.num_frames = frames
    vs.transforms_q = quant(np.array(mats))
    vs.instances[0].transform_index = 0
    return vs


def _field(pkg):
    return (JaxScene if pkg == "jax" else Scene).from_vkr_scene(
        (jproc if pkg == "jax" else procedural).instanced_field(num_inst=6,
                                                                frames=4))


def _queries(n=N, seed=4):
    """Rays from above the field towards the centroids of random triangles
    of its frame-2 pose (most of them on the animated instances)."""
    rng = np.random.default_rng(seed)
    flat = _field("port").flatten_world(frame=2)
    pick = rng.integers(0, flat.num_tris, n)
    target = flat.v0[pick] + (flat.e1[pick] + flat.e2[pick]) / 3.0
    o = np.stack([rng.uniform(-12, 12, n), np.full(n, 15.0),
                  rng.uniform(-12, 12, n)], 1).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_frame2():
    """The JAX renderer on the flattened field at animation frame 2: its
    ray queries (which differ from frame 0's), and a 32x32 frame with its
    rays."""
    jr = jrend.Renderer()
    jr.initialize(SIZE, SIZE)
    jr.set_scene(_field("jax"), scene_config=SC)
    o, d = _queries()
    t0 = np.asarray(jr.render_ray_queries(o, d)[0])
    jr.set_animation_frame(2)
    hits = [np.asarray(x) for x in jr.render_ray_queries(o, d)]
    # the animation moved what these rays hit
    assert (hits[0] != t0).mean() > 0.05
    jr.render(jrend.FrameConfig(camera=CAM, params=RenderParams(
        batch_spp=1, max_path_depth=DEPTH), scene_config=SC))
    return hits, np.asarray(jr.readback_accumulation()), sum(
        int(x) for x in jr._last_rays)


@pytest.mark.parametrize("budget", [None, 0])
def test_set_animation_frame_moves_geometry(route_env, budget):
    """tests/test_animation.py:45-77: the triangle is found where frame 2
    (rebuild) or frame 1 (refit, budget 0) put it, as the JAX renderer
    finds it."""
    answers = []
    for pkg in ("port", "jax"):
        r = (trend.Renderer(device="cpu") if pkg == "port" else jrend.Renderer())
        r.initialize(8, 8)
        if budget is not None:
            r.options = r.options.replace(rebuild_triangle_budget=budget)
        r.set_scene((Scene if pkg == "port" else JaxScene).from_vkr_scene(
            _single_triangle(procedural if pkg == "port" else jproc,
                             quantize_transforms if pkg == "port" else jquant)))
        z = np.array([[0.0, 0.0, -1.0]], np.float32)
        out = [r.render_ray_queries(np.array([[0.0, 0.0, 5.0]], np.float32), z)]
        frame = 2 if budget is None else 1
        r.set_animation_frame(frame)
        for x in (0.0, float(frame)):
            out.append(r.render_ray_queries(np.array([[x, 0.0, 5.0]], np.float32), z))
        answers.append([[np.asarray(a) for a in q] for q in out])
        if pkg == "port":
            assert r.animation_update == ("rebuild" if budget is None else "refit")
            assert r.tlas_update_seconds > 0.0 and r._scene_frame == frame
    port, ref = answers
    assert [int(q[1][0]) for q in port] == [0, -1, 0]
    for p, j in zip(port, ref):
        for a, b in zip(p, j):
            np.testing.assert_array_equal(a, b)


def _on_edge(u, v, eps=1e-4):
    return np.minimum(np.minimum(u, v), 1.0 - u - v) < eps


def _port_field(route, mode, frame=2):
    """The flattened field on ``route``, refit or rebuilt to ``frame``."""
    r = trend.Renderer(device="cpu")
    r.initialize(SIZE, SIZE)
    r.options = r.options.replace(
        quantized_geometry=route == "quantized",
        rebuild_triangle_budget=0 if mode == "refit" else 500000,
        force_bvh_rebuild=mode == "rebuild")
    r.set_scene(_field("port"), scene_config=SC)
    if frame:
        r.set_animation_frame(frame)
    return r


def _real_rows_consistent(r):
    """Each leaf's real-row count is the one its rows' bits give."""
    bvh = r.device_scene.bvh
    if r._route.streamed:
        rows = ts.leaf_rows(bvh)
        counts = traverse.real_row_counts(rows, ts.LEAF)
        return int(counts.min()) >= 1 and counts.shape[0] == rows.shape[0] // ts.LEAF
    return torch.equal(bvh.real_rows,
                       traverse.real_row_counts(bvh.tri_rows, bvh.leaf_size))


@pytest.mark.parametrize("mode", ["refit", "rebuild"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_flattened_animation_on_each_route(route_env, jax_frame2, route, mode):
    for k, v in ROUTES[route].items():
        route_env.setenv(k, v)
    r = _port_field(route, mode)
    assert not r._route.tlas and r.device_scene.tlas is None
    assert r._route.streamed == (route in ("streamed", "quantized"))
    assert r._route.kernel_v3 == (route == "k2k3")
    if route == "k2k3":
        assert isinstance(r.device_scene.bvh, tf.FlatBVH)
    # a quantized pack keeps no refit topology: it always repacks
    assert r.animation_update == ("rebuild" if route == "quantized" else mode)
    assert r._wavefront is None and r.frame_id == 0
    assert _real_rows_consistent(r)
    o, d = _queries()
    t, tri, u, v = r.render_ray_queries(o, d)
    if route == "quantized":
        fresh = trend.Renderer(device="cpu")
        fresh.initialize(SIZE, SIZE)
        fresh.options = fresh.options.replace(quantized_geometry=True)
        fresh.set_scene(_field("port"), scene_config=SC, frame=2)
        want = fresh.render_ray_queries(o, d)
    else:
        want = jax_frame2[0]
    if route == "quantized":
        for a, b in zip((t, tri, u, v), want):
            np.testing.assert_array_equal(a, b)
    else:
        # a ray through a triangle's edge (a barycentric within 1e-4 of 0)
        # may take either side there: XLA's fused walk rounds the edge test
        # otherwise; elsewhere triangles are exact and t within 1e-4 (one
        # grazing hit of these 2,048 reads 1.03e-5: a small determinant
        # amplifies the rounding of t)
        edge = _on_edge(u, v) | _on_edge(want[2], want[3])
        np.testing.assert_array_equal(tri[~edge], want[1][~edge])
        np.testing.assert_allclose(t[~edge], want[0][~edge], rtol=1e-4, atol=0)
        assert (tri != want[1]).mean() < 0.005
    assert (tri >= 0).mean() > 0.5
    # the emitter tables follow the posed scene
    flat = r.scene.flatten_world(frame=2)
    assert r._flat.num_tris == flat.num_tris
    np.testing.assert_array_equal(r._flat.v0, flat.v0)


def test_refit_streamed_matches_jax_and_fresh_pack():
    """refit_streamed against the JAX package's on frame-3 vertices over the
    frame-0 topology (every buffer bitwise), and at rest (frame 0's own
    vertices) bitwise the pack it came from, real-row counts included."""
    scene = _field("port")
    f0, f3 = scene.flatten_world(frame=0), scene.flatten_world(frame=3)
    bb, topo = ts.pack_streamed(f0.v0, f0.e1, f0.e2, with_topology=True,
                                chunk_tris=1024)
    _, jtopo = jts.pack_streamed(f0.v0, f0.e1, f0.e2, with_topology=True,
                                 chunk_tris=1024)
    moved = ts.refit_streamed(topo, f3.v0, f3.e1, f3.e2)
    jmoved = jts.refit_streamed(jtopo, f3.v0, f3.e1, f3.e2)
    for name in ("top_nodes", "sub_nodes", "tri_tiles", "row_tri"):
        np.testing.assert_array_equal(getattr(moved, name).numpy(),
                                      np.asarray(getattr(jmoved, name)), name)
    assert not torch.equal(moved.tri_tiles, bb.tri_tiles)
    rest = ts.refit_streamed(topo, f0.v0, f0.e1, f0.e2)
    for name in ("top_nodes", "sub_nodes", "tri_tiles", "row_tri"):
        assert torch.equal(getattr(rest, name), getattr(bb, name)), name
    assert torch.equal(traverse.real_row_counts(ts.leaf_rows(rest), ts.LEAF),
                       traverse.real_row_counts(ts.leaf_rows(bb), ts.LEAF))


def test_animated_frame_matches_jax(route_env, jax_frame2):
    """A 32x32 frame of the flattened field after set_animation_frame(2)."""
    r = _port_field("k1", "rebuild")
    r.render(trend.FrameConfig(camera=CAM, params=RenderParams(
        batch_spp=1, max_path_depth=DEPTH), scene_config=SC))
    _, jimg, jrays = jax_frame2
    assert r.last_frame_rays() == jrays
    img = r.readback_accumulation()
    assert np.isfinite(img).all() and 0.3 < img[..., 3].mean() < 1.0
    res = goldens.compare_ref(img[..., :3], jimg[..., :3].astype(np.float64))
    assert res["ok"], res
