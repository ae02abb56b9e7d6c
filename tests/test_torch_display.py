"""The port's renderer interface around a frame, against the JAX package's:
the display resolve, ``RenderStats``, ``configure_for`` and the streamed
route's 16-bit quantized tiles.

- ``ops/resolve.py::resolve_channels`` on one HDR accumulation (numpy,
  seeded), in every tone-mapping mode, within 1e-6 of the reference's
  (``exp2``, ``log2`` and ``pow`` are libm calls on both sides).
- ``render`` returns ``RenderStats`` (renderer.py:126-134): the
  accumulated samples, ``rays_per_second`` -1 unless ``stats(force_rays=
  True)``, and zero device bytes on the CPU; ``last_frame_rays``,
  ``reset_accumulation`` and ``supported_variants`` as in the reference.
- ``configure_for`` toggling ``quantized_geometry`` rebuilds the scene:
  the frame equals a fresh ``set_scene`` with the option bitwise; invalid
  values are clamped (False), and a failed rebuild restores the last good
  options (False).
- ``procedural.terrain(48)`` with quantized tiles at 48x48, depth 3, one
  frame, on the streamed route, against the JAX renderer's quantized
  streamed route (its K4/K5 in Pallas interpret mode): equal ray counts,
  and at most ``goldens.REF_FRAC_OVER_1E3`` of pixels over 1e-3 relative.
  The mean relative error is not gated here: XLA contracts the
  interpreted kernels' Moller-Trumbore sums into FMAs, and one path whose
  bounce lands on a triangle edge takes another triangle; measured, one
  pixel of 2,304 differs (by 27%), which alone puts the mean at 1.1e-4.
  The kernels themselves are held to the reference on int16 tiles in
  tests/test_torch_streamed.py.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.ops import resolve as jresolve
from realtimepathtracingresearchframework_tpu.ops import traverse_binned as jtb
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas2 as tp2
from realtimepathtracingresearchframework_tpu.ops import traverse_stream as jts
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    TONEMAP_MODE_FAST,
    TONEMAP_MODE_NEUTRAL,
    TONEMAP_MODE_NO,
    TONEMAP_MODE_OFF,
)
from realtimepathtracingresearchframework_tpu_torch.ops import resolve
from realtimepathtracingresearchframework_tpu_torch.profile_frame import frame_setup

torch.set_num_threads(1)  # see tests/test_torch_render.py

SIZE, DEPTH, GRID = 48, 3, 48


@pytest.mark.parametrize("mode", [TONEMAP_MODE_OFF, TONEMAP_MODE_NO,
                                  TONEMAP_MODE_NEUTRAL, TONEMAP_MODE_FAST])
def test_resolve_channels_matches_reference(mode):
    rng = np.random.default_rng(40 + mode)
    acc = rng.lognormal(-1.0, 2.0, (4, 4096)).astype(np.float32)
    acc[:, :64] = 0.0
    acc[3] = rng.uniform(0.0, 1.5, 4096).astype(np.float32)
    for exposure in (0.0, -1.5):
        out = resolve.resolve_channels([torch.from_numpy(c) for c in acc],
                                       exposure, mode)
        ref = jresolve.resolve_channels(tuple(jnp.asarray(c) for c in acc),
                                        jnp.float32(exposure), mode)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def _terrain(quantized=False, size=16):
    """A small terrain on the streamed route (the caller forces it with
    RPTR_FORCE_STREAMED_TRAVERSAL, which ``set_scene`` reads)."""
    assert os.environ.get("RPTR_FORCE_STREAMED_TRAVERSAL")
    return frame_setup("terrain", "cpu", (size, size), 2, 24,
                       quantized=quantized)


def test_render_returns_stats(monkeypatch):
    monkeypatch.setenv("RPTR_FORCE_STREAMED_TRAVERSAL", "1")
    r, cfg = _terrain()
    # every registered variant but RQ_CLOSEST, the reference's list
    assert r.supported_variants() == jrend.Renderer().supported_variants()
    first = r.render(cfg)
    assert isinstance(first, trend.RenderStats)
    assert first.spp == 1 and first.rays_per_second == -1.0
    assert first.render_time > 0
    assert (first.device_bytes_currently_allocated, first.max_device_bytes_allocated,
            first.total_device_bytes) == (0, 0, 0)
    stats = r.render(cfg)
    assert stats.spp == 2 and r.stats().spp == 2
    forced = r.stats(force_rays=True)
    assert forced.rays_per_second == pytest.approx(
        r.last_frame_rays() / (forced.render_time * 1e-3))
    assert r.last_frame_rays() == r.last_frame_rays() > 0
    r.reset_accumulation()
    assert r.frame_id == 0 and r.stats().spp == 0
    r.render(cfg)
    img = r.readback_accumulation()
    r2, _ = _terrain()
    r2.render(cfg)
    np.testing.assert_array_equal(img, r2.readback_accumulation())


def test_configure_for_quantized_equals_fresh_scene(monkeypatch):
    """``configure_for`` toggling ``quantized_geometry`` rebuilds the scene
    (renderer.py:441-452) and renders what a fresh ``set_scene`` with the
    option renders; toggled back, the f32 frame."""
    monkeypatch.setenv("RPTR_FORCE_STREAMED_TRAVERSAL", "1")
    r, cfg = _terrain()
    f32 = r.device_scene.bvh
    assert not f32.quantized and r._streamed_topo is not None
    r.render(cfg)
    f32_img = r.readback_accumulation()
    assert r.configure_for(r.options.replace(quantized_geometry=True))
    assert r.device_scene.bvh.quantized and r._streamed_topo is None
    fresh, _ = _terrain(quantized=True)
    for a, b in zip(r.device_scene.bvh, fresh.device_scene.bvh):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    r.reset_accumulation()
    r.render(cfg)
    fresh.render(cfg)
    np.testing.assert_array_equal(r.readback_accumulation(),
                                  fresh.readback_accumulation())
    assert r.last_frame_rays() == fresh.last_frame_rays()
    assert r.configure_for(r.options.replace(quantized_geometry=False))
    r.reset_accumulation()
    r.render(cfg)
    np.testing.assert_array_equal(r.readback_accumulation(), f32_img)
    # invalid values are clamped to the lattice and applied
    assert not r.configure_for(r.options.replace(aniso_taps=40))
    assert r.options.aniso_taps == 16
    # a rebuild that fails restores the last good options and scene
    good = r.options

    def fail(*args, **kw):
        raise RuntimeError("no pack")

    bvh = r.device_scene.bvh
    monkeypatch.setattr(trend.traverse_stream, "pack_streamed", fail)
    assert not r.configure_for(good.replace(quantized_geometry=True))
    assert r.options == good and r.device_scene.bvh is bvh


@pytest.fixture(scope="module")
def quantized_frames():
    """terrain(48) with quantized tiles through the port and through the
    JAX renderer's quantized streamed route (Pallas interpret mode)."""
    os.environ["RPTR_FORCE_STREAMED_TRAVERSAL"] = "1"
    try:
        r, cfg = frame_setup("terrain", "cpu", (SIZE, SIZE), DEPTH, GRID,
                             quantized=True)
    finally:
        del os.environ["RPTR_FORCE_STREAMED_TRAVERSAL"]
    r.render(cfg)
    port = (r.readback_accumulation(), r.last_frame_rays(), r)
    select = jrend.Renderer._select_traversal
    jrend.Renderer._select_traversal = lambda self, n: "streamed"
    jts.INTERPRET = jtb.INTERPRET = tp2.INTERPRET = True
    try:
        jr = jrend.Renderer()
        jr.options = jr.options.replace(quantized_geometry=True)
        jr.initialize(SIZE, SIZE)
        jr.set_scene(JaxScene.from_vkr_scene(jproc.terrain(grid=GRID)),
                     scene_config=cfg.scene_config)
        jr.render(jrend.FrameConfig(camera=cfg.camera, params=cfg.params,
                                    scene_config=cfg.scene_config))
        jax_run = (np.asarray(jr.readback_accumulation()),
                   sum(int(x) for x in jr._last_rays), jr)
    finally:
        jrend.Renderer._select_traversal = select
        jts.INTERPRET = jtb.INTERPRET = tp2.INTERPRET = False
    return port, jax_run


def test_quantized_frame_matches_jax(quantized_frames):
    (img, rays, r), (jimg, jrays, jr) = quantized_frames
    assert jr._use_streamed and jr._streamed.tri_tiles.dtype == jnp.int16
    assert r._route.streamed and r.device_scene.bvh.quantized
    assert rays == jrays
    assert np.isfinite(img).all() and img[..., 3].mean() > 0.3
    res = goldens.compare_ref(img[..., :3], jimg[..., :3].astype(np.float64))
    assert res["finite"] and res["frac_over_1e-3"] <= goldens.REF_FRAC_OVER_1E3, res
    disp = r.readback_framebuffer()
    jdisp = np.asarray(jr.readback_framebuffer())
    res = goldens.compare_ref(disp[..., :3], jdisp[..., :3].astype(np.float64))
    assert res["finite"] and res["frac_over_1e-3"] <= goldens.REF_FRAC_OVER_1E3, res


def test_quantized_frame_differs_from_f32_by_the_grid(monkeypatch):
    """Quantized geometry moves vertices by at most half a grid step: the
    frame keeps the f32 frame's ray count within 1% and its image within
    the golden gate's pixel share."""
    monkeypatch.setenv("RPTR_FORCE_STREAMED_TRAVERSAL", "1")
    r, cfg = _terrain(size=24)
    rq, _ = _terrain(quantized=True, size=24)
    r.render(cfg)
    rq.render(cfg)
    assert abs(r.last_frame_rays() - rq.last_frame_rays()) <= 0.01 * r.last_frame_rays()
    res = goldens.compare_golden_gate("terrain", rq.readback_accumulation()[..., :3],
                                      r.readback_accumulation()[..., :3]
                                      .astype(np.float64))
    assert res["finite"]
    assert dataclasses.replace(rq.options, quantized_geometry=False) == r.options
