"""The port's image-domain frame path on the CPU, against the JAX package:
cornell at 32x32, depth 2, 1 spp, three frames with the camera moving
right 0.02 per frame (tests/test_taa.py:67), under ACCUMULATE + TAA +
upscale 2, TAA alone and upscale 2 alone.

- The chain: the port's display after each frame equals the JAX ops
  (``reproject_and_accumulate`` / ``accumulate_history``,
  ``resolve_framebuffer``, ``taa_resolve``) fed with the port's own
  per-frame images and AOVs, in the order of the reference renderer's
  ``render`` (renderer.py:1442-1505), within 1e-5.
- End to end: the port's display equals the JAX renderer's at the golden
  gate (``goldens.compare_golden_gate``), then again after a frame back on
  the planar fast path (the image history re-swizzled into the chunks).
- Checkpoints: a checkpoint the JAX renderer wrote resumes in the port
  (the golden gate against the JAX renderer's uninterrupted frames), and
  the port's save at frame 2, load and two more frames equals four
  uninterrupted frames bitwise, on the planar path and on the upscaled
  image path (ACCUMULATE's previous depth and TAA's history are not in a
  checkpoint, in the reference either).
- ``freeze_frame`` pins the sample sequence; ``timers`` holds the frames'
  RENDERING, PROCESSING, TAA and READBACK.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams as JParams,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.camera import (
    OrientedCamera as JCam,
)
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JScene
from realtimepathtracingresearchframework_tpu.ops import resolve as jres
from realtimepathtracingresearchframework_tpu.ops import taa as jtaa
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    REPROJECTION_MODE_ACCUMULATE,
    RenderParams,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.utils.profiling import (
    ProfilingMarker,
)

torch.set_num_threads(1)  # see tests/test_torch_render.py

SIZE = 48
SPP = 4
DEPTH = 3
FRAMES = 3
EYE, AT = [0, 1.0, 3.2], [0, 1.0, 0.0]
CONFIGS = {  # name -> (ACCUMULATE, TAA, upscale)
    "accumulate_taa_up2": (True, True, 2),
    "taa": (False, True, 1),
    "up2": (False, False, 2),
}


def _params(pkg_params, acc, up):
    kw = dict(batch_spp=SPP, max_path_depth=DEPTH, render_upscale_factor=up)
    if acc:
        kw["reprojection_mode"] = REPROJECTION_MODE_ACCUMULATE
    return pkg_params(**kw)


def _port(taa):
    r = trend.Renderer(device="cpu")
    r.options = r.options.replace(enable_taa=taa)
    r.initialize(SIZE, SIZE)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    return r


def _jax(taa):
    r = jrend.Renderer()
    r.options = r.options.replace(enable_taa=taa)
    r.initialize(SIZE, SIZE)
    r.set_scene(JScene.from_vkr_scene(jproc.cornell_box()))
    return r


def _frames(r, cam_cls, cfg_cls, params, plain, after=None):
    """Render ``FRAMES`` frames, the camera moving right 0.02 after each,
    then one frame at ``plain`` params (the planar fast path); returns each
    frame's display image (and ``after(r)`` of each), and the last frame's
    accumulation and display image."""
    cam = cam_cls.look_at(EYE, AT, fovy=50)
    out = []
    for _ in range(FRAMES):
        r.render(cfg_cls(camera=cam, params=params))
        out.append((np.asarray(r.readback_framebuffer()),
                    after(r) if after else None))
        cam.move(right=0.02)
    r.options = r.options.replace(enable_taa=False)
    r.render(cfg_cls(camera=cam, params=plain))
    assert r.frame_id == (FRAMES + 1) * SPP
    return out, (np.asarray(r.readback_accumulation()),
                 np.asarray(r.readback_framebuffer()))


@pytest.fixture(scope="module")
def port_runs():
    """Each config's port frames, with the frame image that
    ``render_tile_host`` returned and the frame's AOVs (None where the
    frame rendered none)."""
    runs = {}
    real = trend.render_tile_host
    for name, (acc, taa, up) in CONFIGS.items():
        r = _port(taa)
        images = []

        def spy(*a, **k):
            img, rays = real(*a, **k)
            images.append(img.clone())
            return img, rays

        trend.render_tile_host = spy
        try:
            frames, last = _frames(
                r, OrientedCamera, trend.FrameConfig,
                _params(RenderParams, acc, up),
                RenderParams(batch_spp=SPP, max_path_depth=DEPTH),
                after=lambda r: r._aovs)
        finally:
            trend.render_tile_host = real
        assert r._planar
        runs[name] = (r, frames, images, last)
    return runs


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for name, (acc, taa, up) in CONFIGS.items():
        r = _jax(taa)
        frames, last = _frames(r, JCam, jrend.FrameConfig,
                               _params(JParams, acc, up),
                               JParams(batch_spp=SPP, max_path_depth=DEPTH))
        runs[name] = ([f for f, _ in frames], last)
    return runs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chain_matches_the_jax_ops(port_runs, name):
    """The JAX ops run op by op (``jax.disable_jit``), as the other port
    tests hold the reference: jitted, XLA contracts ``uv * dims - 0.5``
    into an FMA, and on a pixel whose reprojected point lands on a texel
    centre (no motion: a miss) ``ceil`` then moves the Lanczos window by
    one tap (2e-5 on cornell's display)."""
    with jax.disable_jit():
        _chain(port_runs, name)


def _chain(port_runs, name):
    acc, taa, up = CONFIGS[name]
    _, frames, images, _ = port_runs[name]
    assert len(images) == FRAMES
    accum = prev_depth = hist = None
    for frame_id, ((disp, aovs), new) in enumerate(zip(frames, images)):
        new = jnp.asarray(new.numpy())
        if acc:
            depth = jnp.asarray(aovs.normal_depth[..., 3].numpy())
            motion = jnp.asarray(aovs.motion_jitter[..., :2].numpy())
            if prev_depth is None or frame_id == 0:
                accum = new
            else:
                accum = jtaa.reproject_and_accumulate(
                    new, accum, motion, depth, prev_depth,
                    jnp.int32(RenderParams().spp_accumulation_window),
                    jnp.int32(frame_id * SPP), jnp.int32(SPP))
            prev_depth = depth
        else:
            accum = jres.accumulate_history(
                new if accum is None else accum, new,
                jnp.int32(frame_id * SPP), jnp.int32(SPP))
        fb = jres.resolve_framebuffer(accum, jnp.float32(0.0),
                                      tonemap_mode=-1, upscale=up)
        if taa:
            motion = jnp.asarray(aovs.motion_jitter[..., :2].numpy())
            motion = jnp.repeat(jnp.repeat(motion, up, axis=0), up, axis=1)
            fb = jtaa.taa_resolve(fb, fb if hist is None or frame_id == 0
                                  else hist, motion)
            hist = fb
        else:
            assert aovs is None  # no AOV pass without ACCUMULATE or TAA
        assert disp.shape == (SIZE * up, SIZE * up, 4)
        np.testing.assert_allclose(disp, np.asarray(fb), rtol=0, atol=1e-5,
                                   err_msg=f"frame {frame_id}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_display_matches_the_jax_renderer(port_runs, jax_runs, name):
    """Each frame's display at the golden gate, then one frame back on the
    planar fast path (no ACCUMULATE, TAA or upscale), whose history is the
    image-domain frames' accumulation."""
    _, frames, _, last = port_runs[name]
    jframes, jlast = jax_runs[name]
    for f, ((disp, _), ref) in enumerate(zip(frames, jframes)):
        res = goldens.compare_golden_gate(goldens.REPROJECTION, disp[..., :3],
                                          ref[..., :3])
        assert res["ok"], (f, res)
    for a, b in zip(last, jlast):
        assert a.shape == b.shape == (SIZE, SIZE, 4)
        res = goldens.compare_golden_gate(goldens.REPROJECTION, a[..., :3],
                                          b[..., :3])
        assert res["ok"], res


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX renderer saves after 2 frames and renders 2 more; the port
    loads its checkpoint and renders the same 2: frame_id, shot_offset and
    the accumulation at the golden gate against the JAX renderer's."""
    params = dict(batch_spp=1, max_path_depth=DEPTH)
    jr = _jax(False)
    cam = JCam.look_at(EYE, AT, fovy=50)
    jr.shot_offset = 3
    for _ in range(2):
        jr.render(jrend.FrameConfig(camera=cam, params=JParams(**params)))
    path = os.path.join(tmp_path, "jax_state.npz")
    jr.save_state(path)
    for _ in range(2):
        jr.render(jrend.FrameConfig(camera=cam, params=JParams(**params)))
    r = trend.Renderer(device="cpu")
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    r.load_state(path)
    assert (r.fb_width, r.fb_height, r.frame_id, r.shot_offset) == (SIZE, SIZE, 2, 3)
    tcam = OrientedCamera.look_at(EYE, AT, fovy=50)
    for _ in range(2):
        r.render(trend.FrameConfig(camera=tcam, params=RenderParams(**params)))
    assert r.frame_id == 4
    res = goldens.compare_golden_gate(
        "cornell_diffuse", r.readback_accumulation()[..., :3],
        jr.readback_accumulation()[..., :3])
    assert res["ok"], res


@pytest.mark.parametrize("upscale", [1, 2])
def test_checkpoint_round_trip_is_bitwise(tmp_path, upscale):
    """Save at frame 2, load into a fresh renderer, 2 more frames: the
    accumulation and display bitwise those of 4 uninterrupted frames, on
    the planar path (upscale 1) and the image-domain path (upscale 2)."""
    cam = OrientedCamera.look_at(EYE, AT, fovy=50)
    cfg = trend.FrameConfig(camera=cam, params=RenderParams(
        batch_spp=1, max_path_depth=DEPTH, render_upscale_factor=upscale))
    whole = _port(False)
    for _ in range(4):
        whole.render(cfg)
    first = _port(False)
    for _ in range(2):
        first.render(cfg)
    path = os.path.join(tmp_path, "state.npz")
    first.save_state(path)
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "fb_height", "fb_width",
                                   "frame_id", "shot_offset"]
        assert z["accum"].shape == (SIZE, SIZE, 4)
    resumed = trend.Renderer(device="cpu")
    resumed.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    resumed.load_state(path)
    assert not resumed._planar
    for _ in range(2):
        resumed.render(cfg)
    assert resumed.frame_id == whole.frame_id == 4
    assert resumed._planar == (upscale == 1)
    for a, b in ((resumed.readback_accumulation(), whole.readback_accumulation()),
                 (resumed.readback_framebuffer(), whole.readback_framebuffer())):
        assert a.tobytes() == b.tobytes()


def test_freeze_frame_pins_the_samples():
    """With ``freeze_frame`` every frame renders the same samples: frame_id
    stays, and the image is the first frame's bitwise, on both paths."""
    cam = OrientedCamera.look_at(EYE, AT, fovy=50)
    for upscale in (1, 2):
        r = _port(False)
        r.freeze_frame = True
        cfg = trend.FrameConfig(camera=cam, params=RenderParams(
            batch_spp=1, max_path_depth=DEPTH, render_upscale_factor=upscale))
        r.render(cfg)
        first = r.readback_framebuffer()
        r.render(cfg)
        assert r.frame_id == 0
        assert r.readback_framebuffer().tobytes() == first.tobytes()
        r.freeze_frame = False
        r.render(cfg)  # sample 0 again, then frame_id moves on
        assert r.frame_id == 1
        assert r.readback_framebuffer().tobytes() == first.tobytes()
        r.render(cfg)
        assert r.readback_framebuffer().tobytes() != first.tobytes()


def test_timers_hold_the_frame_markers(port_runs):
    """On the CPU the markers are host times: every frame adds RENDERING,
    the image-domain frame PROCESSING and, under TAA, TAA; each readback
    READBACK."""
    r = port_runs["accumulate_taa_up2"][0]
    for marker in (ProfilingMarker.RENDERING, ProfilingMarker.PROCESSING,
                   ProfilingMarker.TAA, ProfilingMarker.READBACK):
        avg, mn, mx, sd = r.timers.window_stats(marker)
        assert mn > 0 and mx >= avg >= mn, marker
    assert len(r.timers._history[ProfilingMarker.TAA.value]) >= FRAMES
    up = port_runs["up2"][0]
    assert ProfilingMarker.TAA.value not in up.timers._history


def test_accum_and_framebuffer_properties():
    """``accum`` and ``framebuffer`` are the (H, W, 4) and (H u, W u, 4)
    device tensors the readbacks return, in both modes."""
    r = _port(False)
    cam = OrientedCamera.look_at(EYE, AT, fovy=50)
    for upscale, planar in ((1, True), (2, False)):
        r.render(trend.FrameConfig(camera=cam, params=RenderParams(
            max_path_depth=DEPTH, render_upscale_factor=upscale)))
        assert r._planar == planar
        assert r.framebuffer.shape == (SIZE * upscale, SIZE * upscale, 4)
        np.testing.assert_array_equal(r.accum.numpy(), r.readback_accumulation())
        np.testing.assert_array_equal(r.framebuffer.numpy(),
                                      r.readback_framebuffer())
