"""The port's post-processing ops and extension framework on the CPU,
against the JAX package on the same numpy inputs (made from a seed):

- ``ops/resolve.py``: ``accumulate_history`` and ``resolve_framebuffer`` at
  upscale 1, 2 and 3 under every tone map, within 1e-5;
- ``ops/taa.py``: ``reproject_and_accumulate`` and ``taa_resolve`` within
  1e-5, and the pixels that take the blend (reprojection's ``valid``, TAA's
  ``in_bounds``) exactly the reference's;
- ``integrator.image_to_planes`` and ``planes_to_image``: inverses,
  bitwise, and the reference's layout;
- ``ops/raster.py``: triangle ids equal but on pixels whose winning
  triangle has an edge function within 1e-6 of zero (counted: none on
  these inputs), depth at 1e-5 relative, albedo equal and normals within
  1e-5 (1e-4 on the soup, whose random corner normals can nearly cancel),
  on cornell and on a random soup;
- ``utils/debug.py``: ``assert_all_finite`` names the reference's leaf, and
  the NaN debugging flag makes ``render`` raise on a non-finite pass;
- ``backend/extensions.py``: the RNG tables and RIS emitters that the
  extensions contribute are bitwise what ``set_scene`` built before they
  did (``pointsets.build_rng_buffers`` and ``lights.equalize_emitter_bins``
  called directly), for every RNG variant and bucket count, through
  ``set_scene``, ``configure_for`` and ``set_animation_frame``; the
  profiling tools' CSV header is the reference's; the example step equals
  the reference's; the factory and the lifecycle hooks.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend import extensions as jext
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import raster as jraster
from realtimepathtracingresearchframework_tpu.ops import resolve as jres
from realtimepathtracingresearchframework_tpu.ops import taa as jtaa
from realtimepathtracingresearchframework_tpu.utils import debug as jdebug
from realtimepathtracingresearchframework_tpu.utils.error_io import (
    RenderError as JRenderError,
)
from realtimepathtracingresearchframework_tpu_torch.backend import extensions as text
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    LIGHT_SAMPLING_VARIANT_NONE,
    LIGHT_SAMPLING_VARIANT_RIS,
    RenderParams,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import lights as lights_mod
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import nee as nee_mod
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
from realtimepathtracingresearchframework_tpu_torch.ops import raster as traster
from realtimepathtracingresearchframework_tpu_torch.ops import resolve as tres
from realtimepathtracingresearchframework_tpu_torch.ops import taa as ttaa
from realtimepathtracingresearchframework_tpu_torch.utils import debug as tdebug
from realtimepathtracingresearchframework_tpu_torch.utils.error_io import RenderError

torch.set_num_threads(1)  # see tests/test_torch_render.py

H, W = 36, 64
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _images(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, 4)).astype(np.float32),
            rng.random((h, w, 4)).astype(np.float32), rng)


@pytest.mark.parametrize("base,batch", [(0, 1), (1, 1), (5, 3), (40, 2)])
def test_accumulate_history(base, batch):
    hist, new, _ = _images(1)
    ref = np.asarray(jres.accumulate_history(
        jnp.asarray(hist), jnp.asarray(new), jnp.int32(base), jnp.int32(batch)))
    out = tres.accumulate_history(_t(hist), _t(new), base, batch).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tonemap", [-1, 0, 1, 2])
@pytest.mark.parametrize("upscale", [1, 2, 3])
def test_resolve_framebuffer(upscale, tonemap):
    acc, _, _ = _images(2)
    acc = acc * 4.0  # over 1, so the tone maps act
    ref = np.asarray(jres.resolve_framebuffer(
        jnp.asarray(acc), jnp.float32(0.5), tonemap_mode=tonemap,
        upscale=upscale))
    out = tres.resolve_framebuffer(_t(acc), 0.5, tonemap, upscale).numpy()
    assert out.shape == ref.shape == (H * upscale, W * upscale, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def _motion(rng, scale, h=H, w=W):
    return (rng.standard_normal((h, w, 2)) * scale).astype(np.float32)


@pytest.mark.parametrize("base,window,batch", [(3, 8, 1), (20, 8, 2), (5, 64, 1)])
def test_reproject_and_accumulate(base, window, batch):
    """Within 1e-5, and the pixels that keep the new frame (out of bounds
    or disoccluded: ``valid`` false) exactly the reference's; every case
    has both kinds."""
    new, hist, rng = _images(3)
    motion = _motion(rng, 0.08)
    depth = (1.0 + rng.random((H, W))).astype(np.float32)
    # a third of the history depths off by more than the 10% tolerance
    hdepth = (depth * np.where(rng.random((H, W)) < 0.33, 1.3, 1.0)
              * (1.0 + 0.02 * rng.standard_normal((H, W)))).astype(np.float32)
    ref = np.asarray(jtaa.reproject_and_accumulate(
        jnp.asarray(new), jnp.asarray(hist), jnp.asarray(motion),
        jnp.asarray(depth), jnp.asarray(hdepth), jnp.int32(window),
        jnp.int32(base), jnp.int32(batch)))
    out = ttaa.reproject_and_accumulate(
        _t(new), _t(hist), _t(motion), _t(depth), _t(hdepth), window, base,
        batch).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    # the blend weight is below 1, so a blended pixel differs from the new
    # frame's in every channel
    keep_ref = (ref == new).all(-1)
    keep = (out == new).all(-1)
    np.testing.assert_array_equal(keep, keep_ref)
    assert 0 < keep.sum() < keep.size


@pytest.mark.parametrize("scale", [0.0, 0.05, 0.3])
def test_taa_resolve(scale):
    """Within 1e-5, and the pixels whose reprojected point leaves the
    screen (``in_bounds`` false: the frame's own pixel) exactly the
    reference's."""
    fb, hist, rng = _images(4)
    motion = _motion(rng, scale)
    ref = np.asarray(jtaa.taa_resolve(jnp.asarray(fb), jnp.asarray(hist),
                                      jnp.asarray(motion)))
    out = ttaa.taa_resolve(_t(fb), _t(hist), _t(motion)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal((out == fb).all(-1), (ref == fb).all(-1))
    if scale >= 0.3:
        assert (ref == fb).all(-1).any()


def test_taa_pieces():
    """The Lanczos taps (truncation toward zero before the clamp), the
    edge-clamped shift and the 3x3 statistics against the reference's."""
    img, _, rng = _images(5, 16, 24)
    uv = (rng.random((16, 24, 2)) * 1.4 - 0.2).astype(np.float32)
    np.testing.assert_allclose(
        ttaa._lanczos_sample(_t(img), _t(uv)).numpy(),
        np.asarray(jtaa._lanczos_sample(jnp.asarray(img), jnp.asarray(uv))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        ttaa._bilinear_sample(_t(img), _t(uv)).numpy(),
        np.asarray(jtaa._bilinear_sample(jnp.asarray(img), jnp.asarray(uv))),
        rtol=0, atol=ATOL)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            np.testing.assert_array_equal(
                ttaa._shift_clamped(_t(img), oy, ox).numpy(),
                np.asarray(jtaa._shift_clamped(jnp.asarray(img), oy, ox)))
    for a, b in zip(ttaa._neighborhood_stats(_t(img)),
                    jtaa._neighborhood_stats(jnp.asarray(img))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("size,rays_per_pass", [((16, 16), 256), ((64, 36), 1024),
                                                ((37, 21), 512), ((64, 36), None)])
def test_image_planes_roundtrip(size, rays_per_pass):
    """planes -> image -> planes and image -> planes -> image are the
    identity, bitwise (padding slots 0); at the default pass size the
    planes are the reference's."""
    w, h = size
    kw = {} if rays_per_pass is None else {"rays_per_pass": rays_per_pass}
    img = np.random.default_rng(6).random((h, w, 4)).astype(np.float32)
    planes = ti.image_to_planes(img, w, h, **kw)
    valid = ti.swizzle_host(w, h, **kw)[2]
    assert not planes[:, ~valid].any()
    back = ti.planes_to_image(planes, w, h, **kw)
    assert back.tobytes() == img.tobytes()
    assert ti.image_to_planes(back, w, h, **kw).tobytes() == planes.tobytes()
    if rays_per_pass is None:
        ref = ji.image_to_planes(img, w, h)
        assert planes.tobytes() == np.ascontiguousarray(ref).tobytes()


def _soup(seed, n=150):
    """Random triangles in front of the default camera, with normals and
    materials."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([-2, -1, -3], [2, 3, -0.5], (n, 3)).astype(np.float32)
    v0 = c + rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    ns = [rng.normal(0, 1, (n, 3)).astype(np.float32) for _ in range(3)]
    base = rng.random((5, 3)).astype(np.float32)
    mat = rng.integers(0, 5, n).astype(np.int32)
    return (v0, e1, e2, *ns, base, mat)


def _cornell():
    scene = Scene.from_vkr_scene(procedural.cornell_box())
    flat = scene.flatten_world()
    return (flat.v0, flat.e1, flat.e2, flat.n0, flat.n1, flat.n2,
            np.asarray(scene.material_table().base_color, np.float32),
            np.asarray(flat.material_id, np.int32))


def _edge_min(tris, tri, w, h, cam):
    """min |edge function| of each pixel's triangle ``tri`` at the pixel
    centre (the screen-space coverage test of ops/raster.py), from the
    reference's projection."""
    pos, du, dv, tl = (jnp.asarray(a) for a in cam.view_basis(w, h))
    v0, e1, e2 = (jnp.asarray(a) for a in tris[:3])
    proj = [jraster._project(pos, du, dv, tl, p) for p in (v0, v0 + e1, v0 + e2)]
    k = np.maximum(tri.reshape(-1), 0)
    (u0, q0, _), (u1, q1, _), (u2, q2, _) = (
        (np.asarray(u)[k], np.asarray(v)[k], None) for u, v, _ in proj)
    pxg = np.tile((np.arange(w) + 0.5) / w, h).astype(np.float32)
    pyg = np.repeat((np.arange(h) + 0.5) / h, w).astype(np.float32)
    ax, ay, bx, by = u0 - pxg, q0 - pyg, u1 - pxg, q1 - pyg
    cx, cy = u2 - pxg, q2 - pyg
    e = np.stack([ax * by - ay * bx, bx * cy - by * cx, cx * ay - cy * ax])
    return np.abs(e).min(0).reshape(h, w)


@pytest.mark.parametrize("name,size", [("cornell", (48, 48)), ("cornell", (64, 36)),
                                       ("soup", (64, 36))])
def test_raster_gbuffer(name, size):
    """Triangle ids equal but where the winner's edge function is within
    1e-6 of zero at the pixel centre (a pixel on a shared edge; counted,
    none in these cases), depth at 1e-5 relative, normals and albedo at
    1e-5 on pixels of the same triangle."""
    w, h = size
    tris = _cornell() if name == "cornell" else _soup(7)
    cam = (OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
           if name == "cornell" else
           OrientedCamera.look_at([0, 1.0, 3.0], [0, 1.0, 0.0], fovy=60))
    view = cam.view_basis(w, h)
    ref = jraster.raster_gbuffer(*(jnp.asarray(a) for a in tris + view), w, h)
    out = traster.raster_gbuffer(*(_t(np.asarray(a)) for a in tris + view), w, h)
    rtri, otri = np.asarray(ref.tri), out.tri.numpy()
    assert otri.shape == (h, w) and otri.dtype == np.int32
    differ = rtri != otri
    near = (_edge_min(tris, rtri, w, h, cam) < 1e-6) | (
        _edge_min(tris, otri, w, h, cam) < 1e-6)
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)
    assert differ.sum() == 0, f"{differ.sum()} pixels differ on an edge"
    same = ~differ & (rtri >= 0)
    assert same.sum() > 0.3 * w * h
    rd, od = np.asarray(ref.depth), out.depth.numpy()
    np.testing.assert_allclose(od[same], rd[same], rtol=1e-5)
    assert np.isinf(od[rtri < 0]).all()
    np.testing.assert_array_equal(out.albedo.numpy()[same],
                                  np.asarray(ref.albedo)[same])
    # the soup's random corner normals can nearly cancel in the blend, and
    # the normalisation then scales the last bits of the barycentrics
    np.testing.assert_allclose(out.normal.numpy()[same],
                               np.asarray(ref.normal)[same], rtol=0,
                               atol=ATOL if name == "cornell" else 1e-4)


def test_raster_gbuffer_pixel_blocks(monkeypatch):
    """The pixel blocks change no value: one block of 64 pixels against
    the whole frame at once."""
    tris = _soup(8, n=70)
    cam = OrientedCamera.look_at([0, 1.0, 3.0], [0, 1.0, 0.0], fovy=60)
    args = [_t(np.asarray(a)) for a in tris + cam.view_basis(40, 24)]
    whole = traster.raster_gbuffer(*args, 40, 24)
    monkeypatch.setattr(traster, "PIXEL_BLOCK", 64)
    blocked = traster.raster_gbuffer(*args, 40, 24)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_renderer_raster_gbuffer_matches_reference():
    """``Renderer.render_raster_gbuffer`` rasterises the renderer's
    flattened scene as the reference's renderer does."""
    from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
    from realtimepathtracingresearchframework_tpu.models import procedural as jproc
    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera as JCam,
    )
    from realtimepathtracingresearchframework_tpu.models.scene import Scene as JScene

    r = Renderer(device="cpu")
    r.initialize(48, 36)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    cam = OrientedCamera.look_at([0.3, 1.2, 3.0], [0, 1.0, 0.0], fovy=55)
    gb = r.render_raster_gbuffer(FrameConfig(camera=cam))
    jr = jrend.Renderer()
    jr.initialize(48, 36)
    jr.set_scene(JScene.from_vkr_scene(jproc.cornell_box()))
    ref = jr.render_raster_gbuffer(jrend.FrameConfig(
        camera=JCam.look_at([0.3, 1.2, 3.0], [0, 1.0, 0.0], fovy=55)))
    np.testing.assert_array_equal(gb.tri.numpy(), np.asarray(ref.tri))
    hit = np.asarray(ref.tri) >= 0
    np.testing.assert_allclose(gb.depth.numpy()[hit], np.asarray(ref.depth)[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(gb.albedo.numpy(), np.asarray(ref.albedo),
                               rtol=0, atol=ATOL)


def test_assert_all_finite_names_the_reference_leaf():
    bad = np.ones((3, 2), np.float32)
    bad[1, 1] = np.nan
    tree = {"b": (np.ones(2, np.float32), bad), "a": [np.arange(3)],
            "c": np.float32(1.0)}
    ttree = {"b": (torch.ones(2), _t(bad)), "a": [torch.arange(3)],
             "c": np.float32(1.0)}
    with pytest.raises(JRenderError) as ref:
        jdebug.assert_all_finite(tree, "frame")
    with pytest.raises(RenderError) as port:
        tdebug.assert_all_finite(ttree, "frame")
    assert str(port.value) == str(ref.value)
    tdebug.assert_all_finite({"a": torch.ones(3), "b": (np.zeros(2),)})


def test_nan_debugging_names_the_pass(monkeypatch):
    """Under ``enable_nan_debugging`` a pass that leaves a NaN in its
    chunk's accumulators makes ``render`` raise naming the frame, sample
    and chunk; without it the frame completes."""
    from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend

    real = trend.make_pass_fn

    def poisoned(*a, **k):
        fn = real(*a, **k)

        def pass_fn(fp, view, acc, px, py, valid, s, base):
            out = fn(fp, view, acc, px, py, valid, s, base)
            if s == 1 and int(px[0]) == 0 and int(py[0]) == 16:
                acc[2][5] = float("nan")
            return out
        return pass_fn

    monkeypatch.setattr(trend, "make_pass_fn", poisoned)
    r = Renderer(device="cpu", rays_per_pass=256)
    r.initialize(16, 32)  # two chunks of one 16x16 tile each
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    cfg = FrameConfig(camera=OrientedCamera.look_at([0, 1, 3.2], [0, 1, 0], fovy=50),
                      params=RenderParams(max_path_depth=1))
    r.render(cfg, batch_spp=2)  # off: no check
    assert np.isnan(r.readback_accumulation()).any()
    tdebug.enable_nan_debugging()
    try:
        for upscale in (1, 2):  # the planar path, the image-domain path
            r.initialize(16, 32)
            r.render(cfg, batch_spp=1)
            with pytest.raises(RenderError, match="frame 1 sample 1 chunk 1"):
                r.render(FrameConfig(camera=cfg.camera, params=RenderParams(
                    max_path_depth=1, render_upscale_factor=upscale)),
                    batch_spp=2)
    finally:
        tdebug.disable_nan_debugging()
    assert not tdebug.nan_debugging()


# ---------------------------------------------------------------------------
# Extensions
# ---------------------------------------------------------------------------


def _rng_fields(bufs):
    return {k: v for k, v in bufs._asdict().items()}


def _assert_rng_equal(got, want):
    for k, v in _rng_fields(want).items():
        g = _rng_fields(got)[k]
        assert g.dtype == v.dtype and torch.equal(g, v), k


def _parent_lights(r, variant, buckets):
    """The emitter buffers as ``set_scene`` built them before the
    extensions contributed them."""
    tl = lights_mod.collect_emitters(r._flat, r._mat_table)
    bin_size = None
    if variant == LIGHT_SAMPLING_VARIANT_RIS and tl.count > 0:
        bin_size = min(max(1, int(buckets)), tl.count)
        tl = lights_mod.equalize_emitter_bins(tl, bin_size)
    count = tl.count
    if count == 0:
        tl = lights_mod.empty_lights()
    return nee_mod.light_buffers(tl.v0, tl.v1, tl.v2, tl.radiance,
                                 r.device), bin_size, count


def _assert_lights_equal(r, variant, buckets):
    lights, bin_size, count = _parent_lights(r, variant, buckets)
    assert r._bin_size == bin_size and r._num_lights == count
    for a, b in zip(r.device_scene.lights, lights):
        for x, y in zip(a, b):  # Vec3 columns
            assert torch.equal(x, y)


@pytest.mark.parametrize("scene_name", ["cornell", "sun_sky"])
def test_extension_payload_is_the_parents(scene_name):
    """For every RNG variant, light-sampling variant and bucket count
    (0, clamped to 1, 1, 4 and 16): the RNG tables and emitter buffers of
    ``set_scene``, of ``configure_for`` and of ``set_animation_frame``
    are bitwise what the renderer built before the extensions did."""
    vs = procedural.cornell_box(light=scene_name == "cornell")
    scene = Scene.from_vkr_scene(vs)
    r = Renderer(device="cpu")
    r.initialize(16, 16)
    for rng_variant in range(4):
        for ls in (LIGHT_SAMPLING_VARIANT_NONE, LIGHT_SAMPLING_VARIANT_RIS):
            for buckets in (0, 1, 4, 16):
                r.options = r.options.replace(
                    rng_variant=rng_variant, light_sampling_variant=ls,
                    light_sampling_bucket_count=buckets)
                r.set_scene(scene)
                _assert_rng_equal(r.device_scene.rng,
                                  pointsets.build_rng_buffers(rng_variant))
                _assert_lights_equal(r, ls, buckets)
    r.set_animation_frame(0)
    _assert_rng_equal(r.device_scene.rng, pointsets.build_rng_buffers(3))
    _assert_lights_equal(r, LIGHT_SAMPLING_VARIANT_RIS, 16)
    for rng_variant, ls, buckets in ((1, LIGHT_SAMPLING_VARIANT_RIS, 4),
                                     (2, LIGHT_SAMPLING_VARIANT_NONE, 4),
                                     (0, LIGHT_SAMPLING_VARIANT_RIS, 1)):
        r.configure_for(r.options.replace(
            rng_variant=rng_variant, light_sampling_variant=ls,
            light_sampling_bucket_count=buckets))
        _assert_rng_equal(r.device_scene.rng,
                          pointsets.build_rng_buffers(rng_variant))
        _assert_lights_equal(r, ls, buckets)


def test_default_extensions_follow_the_reference():
    """The default extensions, their names and their activity under each
    option set are the reference's; the factory makes the same steps."""
    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderBackendOptions as JOptions,
    )
    from realtimepathtracingresearchframework_tpu_torch.backend.params import (
        RenderBackendOptions,
    )

    r = Renderer(device="cpu")
    jr = types.SimpleNamespace(options=JOptions())
    ref = jext.create_default_extensions(jr)
    assert [e.name() for e in r.extensions] == [e.name() for e in ref]
    for rng_variant in range(4):
        for ls in (LIGHT_SAMPLING_VARIANT_NONE, LIGHT_SAMPLING_VARIANT_RIS):
            for taa in (False, True):
                kw = dict(rng_variant=rng_variant, light_sampling_variant=ls,
                          enable_taa=taa, light_sampling_bucket_count=0)
                rbo, jrbo = RenderBackendOptions(**kw), JOptions(**kw)
                assert ([e.is_active_for(rbo) for e in r.extensions]
                        == [e.is_active_for(jrbo) for e in ref])
                assert ([e.normalize_options(rbo).light_sampling_bucket_count
                         for e in r.extensions]
                        == [e.normalize_options(jrbo).light_sampling_bucket_count
                            for e in ref])
                step = r.create_processing_step(text.RenderProcessingStep.TAA)
                assert step.is_active_for(rbo) == taa
    for step in text.RenderProcessingStep:
        port = r.create_processing_step(step)
        want = jext.create_processing_step(jr, jext.RenderProcessingStep(step.value))
        assert (port is None) == (want is None), step
        if port is not None:
            assert port.name() == want.name()
    a = r.get_processing_step(text.RenderProcessingStep.PROFILING_TOOLS)
    assert a is r.get_processing_step(text.RenderProcessingStep.PROFILING_TOOLS)


def test_profiling_tools_csv_header_is_the_references():
    port = text.ProfilingToolsExtension(None)
    ref = jext.ProfilingToolsExtension(None)
    assert port.csv_header() == ref.csv_header()
    assert len(port.csv_header()) == 24


def test_profiling_tools_read_the_frames():
    """After frames on the CPU the window holds RENDERING (every frame),
    PROCESSING and READBACK (a readback) and BUILD_BLAS (set_scene)."""
    r = Renderer(device="cpu")
    r.initialize(16, 16)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    cfg = FrameConfig(camera=OrientedCamera.look_at([0, 1, 3.2], [0, 1, 0], fovy=50),
                      params=RenderParams(max_path_depth=1))
    r.render(cfg)
    r.readback_framebuffer()
    r.render(cfg)
    ext = r.get_processing_step(text.RenderProcessingStep.PROFILING_TOOLS)
    vals = dict(zip(ext.csv_header(), ext.csv_values()))
    assert vals["rendering_avg_ms"] > 0 and vals["buildblas_avg_ms"] > 0
    assert vals["readback_max_ms"] > 0 and vals["processing_max_ms"] > 0
    assert vals["taa_max_ms"] == 0.0
    assert len(r.timers._history["Rendering"]) == 2


def test_example_step_matches_the_reference():
    """The example processing step on the same accumulation and frame:
    within 1e-5 where the image is opaque (alpha 1) and on the fractal
    background (alpha < 1)."""
    acc, _, rng = _images(9, 24, 40)
    acc[..., 3] = np.where(rng.random((24, 40)) < 0.5, 1.0, acc[..., 3])
    jb = types.SimpleNamespace(accum=jnp.asarray(acc), frame_id=7)
    jext.ExampleExtension(jb).process()
    tb = types.SimpleNamespace(accum=_t(acc), frame_id=7)
    text.ExampleExtension(tb).process()
    np.testing.assert_allclose(tb.accum.numpy(), np.asarray(jb.accum),
                               rtol=0, atol=ATOL)


def test_extension_lifecycle_hooks():
    """initialize (at ``initialize``), update_scene_from_backend (after
    ``set_scene``), preprocess (every frame, active extensions only),
    normalize_options / configure_for (``configure_for``, which an
    extension may refuse) in the reference's order."""
    calls = []

    class Probe(text.RenderExtension):
        refuse = False

        def name(self):
            return "probe"

        def initialize(self, w, h):
            calls.append(("init", w, h))

        def update_scene_from_backend(self, scene):
            calls.append(("scene", scene.unique_tris))

        def normalize_options(self, rbo):
            calls.append(("normalize",))
            return rbo.replace(aniso_taps=2)

        def configure_for(self, rbo, available=None):
            calls.append(("configure", rbo.aniso_taps))
            return not self.refuse

        def preprocess(self, variant_idx=0):
            calls.append(("pre",))

    r = Renderer(device="cpu")
    probe = Probe(r)
    r.extensions.append(probe)
    r.initialize(16, 16)
    scene = Scene.from_vkr_scene(procedural.cornell_box())
    r.set_scene(scene)
    cfg = FrameConfig(camera=OrientedCamera.look_at([0, 1, 3.2], [0, 1, 0], fovy=50),
                      params=RenderParams(max_path_depth=1))
    r.render(cfg)
    assert calls == [("init", 16, 16), ("scene", scene.unique_tris), ("pre",)]
    calls.clear()
    assert r.configure_for(r.options) is False  # normalised: not as asked
    assert calls == [("normalize",), ("configure", 2)]
    assert r.options.aniso_taps == 2
    probe.refuse = True
    assert r.configure_for(r.options.replace(aniso_taps=0)) is False
    assert r.options.aniso_taps == 2  # refused: not applied
    probe.mute_flag = True
    calls.clear()
    r.render(cfg)
    assert calls == []
