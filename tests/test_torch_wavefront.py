"""The port's large-scene route on the CPU: the flat-cull kernels' plain
versions, the coherence sort and the bounce-major wavefront executor.

``procedural.terrain(grid=24)`` (1,152 triangles) is forced onto the
route the renderer takes from 16,384 triangles (``RPTR_TRAVERSAL_V3=1``:
K2 on primaries, K3 on sorted queues, the wavefront executor) and rendered
at 32x32, depth 5, two 1-spp frames, with the sun, sky and camera of
bench.py's terrain row.

- Against the port's own monolith (``RPTR_HOST_WAVEFRONT=0
  RPTR_COMPACT_LANES=0``): ray counts equal and the image bitwise equal.
  The executor runs the same elementwise work on permuted lanes, and
  traversal is exact under any lane order.
- Against the JAX renderer on the CPU with ``RPTR_HOST_WAVEFRONT=1`` (XLA
  traversal there): ray counts per frame, live lanes per bounce and the
  first-hit triangle of every pixel exact; radiance at
  ``goldens.compare_ref``'s 1% of pixels over 1e-3 and 1e-4 mean relative
  error. Measured: no pixel over 1e-3, mean relative error 1.0e-7, worst
  channel 2.6e-6 (XLA's fused programs contract multiply-adds the port
  rounds separately).
- The route as a function of the triangle count (16,383 / 16,384 / 90,000
  / 90,001 and the overrides), against the JAX renderer's policy as it
  applies on a chip (on the CPU it takes XLA traversal, so the policy is
  read from its methods, not from a render). Above 90,000 both stream.
"""
import dataclasses

import os
import sys
from types import SimpleNamespace

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
from realtimepathtracingresearchframework_tpu.ops.traverse import (
    closest_hit_threaded,
)
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    map_rows_to_tris,
)
from realtimepathtracingresearchframework_tpu_torch.profile_frame import frame_setup

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_alpha import fresh_jax_wavefront  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

SIZE, DEPTH, GRID, FRAMES = 32, 5, 24, 2
ROUTE_ENV = ("RPTR_TRAVERSAL_V3", "RPTR_HOST_WAVEFRONT", "RPTR_COMPACT_LANES",
             "RPTR_COMPACT", "RPTR_KERNEL_V4", "RPTR_TRAVERSAL_V1",
             "RPTR_FORCE_STREAMED_TRAVERSAL", "RPTR_STREAM_CLOSEST")


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


def _port(**kv):
    """Two frames through the port on the CPU: (image, rays per frame,
    renderer, frame config)."""
    with _env(RPTR_TRAVERSAL_V3="1", **kv):
        r, cfg = frame_setup("terrain", "cpu", (SIZE, SIZE), DEPTH, GRID)
        rays = []
        for _ in range(FRAMES):
            r.render(cfg)
            rays.append(r.last_frame_rays())
    return r.readback_accumulation(), rays, r, cfg


@pytest.fixture(scope="module")
def renders():
    """The port's wavefront and monolith renders and the JAX renderer's
    wavefront render of the same frames (one each)."""
    wf = _port()
    mono = _port(RPTR_HOST_WAVEFRONT="0", RPTR_COMPACT_LANES="0")
    _, _, _, cfg = wf
    fresh_jax_wavefront()
    with _env(RPTR_HOST_WAVEFRONT="1"):
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
    return {"wf": wf, "mono": mono, "jax": jax_run}


def test_route_taken(renders):
    """The forced route: a flat BVH, the wavefront executor, K2/K3 plain
    versions (no launches on the CPU)."""
    img, rays, r, _ = renders["wf"]
    assert isinstance(r.device_scene.bvh, tf.FlatBVH)
    assert r._wavefront is not None and r.live_profile[0] > 0
    cfg = r._integrator_config(RenderParams(max_path_depth=DEPTH))
    assert cfg.kernel_v3 and cfg.kernel_v4 and cfg.compact_lanes
    _, _, rm, _ = renders["mono"]
    assert rm._wavefront is None
    assert np.isfinite(img).all() and (img >= 0).all()
    assert img[..., 3].mean() > 0.3  # the terrain covers much of the frame


def test_wavefront_equals_monolith(renders):
    wf_img, wf_rays, _, _ = renders["wf"]
    mono_img, mono_rays, _, _ = renders["mono"]
    assert wf_rays == mono_rays
    np.testing.assert_array_equal(wf_img, mono_img)


def test_wavefront_matches_jax(renders):
    wf_img, wf_rays, r, _ = renders["wf"]
    jimg, jrays, jr, _ = renders["jax"]
    assert jr._wf_progs  # the JAX renderer took its wavefront executor
    assert wf_rays == jrays
    assert r.live_profile == jr._wf_live_profile
    res = goldens.compare_ref(wf_img[..., :3], jimg[..., :3].astype(np.float64))
    assert res["ok"], res


def test_first_hit_triangles_match_jax(renders):
    """Sample 0's primaries: K2's plain version (the route's primary
    dispatch) against the JAX renderer's traversal, triangle for
    triangle."""
    _, _, r, cfg = renders["wf"]
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
    bvh = r.device_scene.bvh
    tri_port = map_rows_to_tris(bvh, tf.closest_hit_flat(bvh, ro, rd)).tri.numpy()
    np.testing.assert_array_equal(tri_port[valid], tri_jax[valid])
    assert (tri_jax[valid] >= 0).mean() > 0.3


def _jax_policy(num_tris):
    """The JAX renderer's choices for a static untextured scene on a chip:
    _select_traversal (renderer.py:588-608), the v3 and compact defaults
    (:815-835), _integrator_config (:1104-1157) and _use_wavefront_host
    (:480-499), read from its methods on a stand-in renderer."""
    chip = SimpleNamespace(device=SimpleNamespace(platform="tpu"))
    mode = jrend.Renderer._select_traversal(chip, num_tris)
    pallas = mode == "pallas"
    v3_env = os.environ.get("RPTR_TRAVERSAL_V3")
    state = SimpleNamespace(
        _use_pallas=pallas,
        _use_streamed=mode == "streamed",
        _use_pallas3=pallas and not os.environ.get("RPTR_TRAVERSAL_V1") and (
            num_tris >= jrend._V3_MIN_TRIS if v3_env is None else v3_env != "0"),
        _compact_default=pallas and num_tris >= jrend._COMPACT_MIN_TRIS,
        options=jrend.RenderBackendOptions(), _use_bins=False, _num_lights=0,
        _has_textures=False,
        _stream_closest_strategy=lambda: jrend.Renderer._stream_closest_strategy(
            jrend.Renderer),
        _multi=False, device_scene=object(),
    )
    cfg = jrend.Renderer._integrator_config(state, JaxRenderParams())
    return mode, cfg, jrend.Renderer._use_wavefront_host(state, cfg)


@pytest.mark.parametrize("env", [
    {}, {"RPTR_TRAVERSAL_V3": "1"}, {"RPTR_TRAVERSAL_V3": "0"},
    {"RPTR_KERNEL_V4": "0"}, {"RPTR_HOST_WAVEFRONT": "0"},
    {"RPTR_HOST_WAVEFRONT": "1", "RPTR_COMPACT_LANES": "0"},
    {"RPTR_COMPACT": "0", "RPTR_COMPACT_LANES": "0"}, {"RPTR_COMPACT": "1"},
    {"RPTR_FORCE_STREAMED_TRAVERSAL": "1"},
    {"RPTR_FORCE_STREAMED_TRAVERSAL": "1", "RPTR_STREAM_CLOSEST": "binned"},
    {"RPTR_TRAVERSAL_V1": "1"}, {"RPTR_TRAVERSAL_V1": "1", "RPTR_TRAVERSAL_V3": "1"},
], ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "default")
@pytest.mark.parametrize("num_tris", [16_383, 16_384, 90_000, 90_001])
def test_route_by_triangle_count(num_tris, env):
    with _env(**env):
        mode, jcfg, jwave = _jax_policy(num_tris)
        r = trend.Renderer(device="cpu")
        r._route = route = trend.route_for(num_tris)
        r.device_scene = object()
        cfg = r._integrator_config(RenderParams())
        assert route.streamed == (mode == "streamed")
        if mode == "pallas" and os.environ.get("RPTR_TRAVERSAL_V1"):
            assert route.v1 and route.leaf_size == 128  # renderer.py:837-838
        elif mode == "pallas":
            assert route.leaf_size == (
                32 if num_tris <= 24_000 else 64 if num_tris <= 48_000 else 128)
        for field in ("kernel_v3", "kernel_v4", "compact", "compact_lanes",
                      "streamed", "stream_closest"):
            assert getattr(cfg, field) == getattr(jcfg, field), field
        assert r._use_wavefront_host(cfg) == jwave


def test_route_limits(monkeypatch):
    """Above the resident cap set_scene takes the streamed route; with
    ``quantized_geometry`` it packs 16-bit tiles and keeps no refit
    topology (renderer.py:788-792); ``RPTR_TRAVERSAL_V1`` selects the v1
    walk (K8a/K8b) at leaf 128 below the cap; ``RPTR_COMPACT_LANES=1``
    with the monolith renders (a 16x16 frame has too few lanes for a
    second prefix size, so the frame is the uncompacted one)."""
    assert trend.route_for(213 * 213 * 2).streamed
    monkeypatch.setenv("RPTR_FORCE_STREAMED_TRAVERSAL", "1")
    r = trend.Renderer(device="cpu")
    r.initialize(16, 16)
    r.options = dataclasses.replace(r.options, quantized_geometry=True)
    r.set_scene(Scene.from_vkr_scene(tproc.terrain(grid=24)))
    assert r._route.streamed and r.device_scene.bvh.quantized
    assert r._streamed_topo is None
    monkeypatch.delenv("RPTR_FORCE_STREAMED_TRAVERSAL")
    monkeypatch.setenv("RPTR_TRAVERSAL_V1", "1")
    route = trend.route_for(1000)
    assert route.v1 and route.leaf_size == 128 and not route.kernel_v3
    assert trend.route_for(213 * 213 * 2).streamed
    monkeypatch.delenv("RPTR_TRAVERSAL_V1")
    monkeypatch.setenv("RPTR_HOST_WAVEFRONT", "0")
    images = []
    for flag in ("1", "0"):
        monkeypatch.setenv("RPTR_COMPACT_LANES", flag)
        r, cfg = frame_setup("cornell", "cpu", (16, 16), 3)
        assert r._integrator_config(cfg.params).compact_lanes == (flag == "1")
        r.render(cfg)
        images.append(r.readback_accumulation())
    np.testing.assert_array_equal(images[0], images[1])
