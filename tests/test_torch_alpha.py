"""The port's alpha test on the CPU, against the JAX renderer.

- The three cases of ``tests/test_alpha_test.py:60-120`` on the port: an
  alpha-checkered quad in front of an emissive wall, 16x16, depth 1,
  through K1's plain version, and on the two-level route through plain K6
  and plain K7; an opaque texture that turns the alpha test off. Each
  keeps the reference test's own checks and matches the JAX renderer's
  frame: ray counts equal, and ``goldens.compare_card``'s gate (the
  reference renders XLA-fused programs).
- ``procedural.village(grid=24)`` at 32x32, depth 3, forced onto the
  flat-cull route (``RPTR_TRAVERSAL_V3=1``: K2 and K3's plain versions and
  the wavefront executor, with textures; the village's textures are opaque,
  so no alpha hops) against the JAX renderer's bounce-major executor:
  ray counts exact, radiance at ``goldens.compare_card``'s gate.
"""

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderBackendOptions as JaxOptions,
)
from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams as JaxRenderParams,
)
from realtimepathtracingresearchframework_tpu.backend.params import (
    SceneConfig as JaxSceneConfig,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    FrameConfig as JaxFrameConfig,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    Renderer as JaxRenderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models import vkr as jvkr
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.models.texture import (
    Texture as JaxTexture,
)
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models import vkr as tvkr
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.models.texture import Texture
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas
from realtimepathtracingresearchframework_tpu_torch.utils import profiling

CAM = OrientedCamera.look_at([0, 0, 3], [0, 0, -1], fovy=45)


def fresh_jax_wavefront():
    """Re-import the JAX package's ``ops/wavefront_host.py`` when a JAX
    renderer's ``hot_reload`` in this process (tests/test_backend_features.py
    on the same xdist worker) has reloaded ``ops/vec3.py`` under it: the
    executor would keep the old ``Vec3`` class and its ``lax.cond`` would
    see two (ROADMAP queue 3's order dependence)."""
    import importlib

    from realtimepathtracingresearchframework_tpu.ops import vec3, wavefront_host

    if wavefront_host.Vec3 is not vec3.Vec3:
        importlib.reload(wavefront_host)


def _alpha_scene(proc, vkr, scene_cls, tex_cls, alpha_checker=True, n=2):
    """tests/test_alpha_test.py:17-57 with the given package's modules."""
    rgba = np.full((n, n, 4), 255, np.uint8)
    if alpha_checker:
        yy, xx = np.mgrid[0:n, 0:n]
        rgba[..., 3] = np.where((xx + yy) % 2 == 0, 255, 0).astype(np.uint8)
    tex = tex_cls(n, n, 37, mips=[rgba], srgb=False)
    wall = proc.make_mesh(
        "wall", proc._quad([-4, -4, -1], [4, -4, -1], [4, 4, -1], [-4, 4, -1]))
    uvs = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                   np.float32)
    quad = proc.make_mesh(
        "quad", proc._quad([-2, -2, 1], [2, -2, 1], [2, 2, 1], [-2, 2, 1]),
        tri_uvs=uvs)
    mats = [
        vkr.VkrMaterial(name="wall",
                        emitter_base_color=np.array([1.0, 1.0, 1.0], np.float32),
                        emission_intensity=5.0),
        vkr.VkrMaterial(name="cutout", tex_base_color=tex),
    ]
    scene = scene_cls.from_vkr_scene(proc.identity_scene([wall, quad], mats))
    scene.parameterized_meshes[1].material_offset = 1
    return scene


def _render_pair(alpha_checker, size, two_level=False):
    """(port renderer, port image, JAX renderer, JAX image) of one case."""
    r = Renderer(device="cpu")
    r.options = r.options.replace(use_tlas=two_level)
    r.initialize(size, size)
    r.set_scene(_alpha_scene(tproc, tvkr, Scene, Texture, alpha_checker))
    ti.reset_alpha_counts()
    profiling.reset_host_syncs()
    r.render(FrameConfig(camera=CAM, params=RenderParams(max_path_depth=1)))
    img = r.readback_accumulation()
    jr = JaxRenderer()
    jr.initialize(size, size)
    jr.configure_for(JaxOptions(use_tlas=two_level))
    jr.set_scene(_alpha_scene(jproc, jvkr, JaxScene, JaxTexture, alpha_checker))
    jr.render(JaxFrameConfig(camera=CAM, params=JaxRenderParams(max_path_depth=1)))
    return r, img, jr, np.asarray(jr.accum)


def _check_cutout(img):
    """The reference test's checks: some rays punch through to the wall,
    solid texels block it, about half the quad is cut."""
    lum = img[..., :3].sum(-1)
    bright = lum > 3.0
    assert bright.any(), "no rays punched through alpha cutouts"
    assert (~bright).any(), "solid texels did not block the wall"
    assert 0.2 < bright.mean() < 0.8


def _check_matches(r, img, jr, ref):
    assert r.last_frame_rays() == sum(int(x) for x in jr._last_rays)
    if not ref[..., :3].any():  # an all-black frame has no relative error
        assert not img[..., :3].any()
        return
    res = goldens.compare_card(img[..., :3], ref[..., :3])
    assert res["ok"], res


def test_alpha_cutout_reveals_background():
    r, img, jr, ref = _render_pair(True, 16)
    assert r._has_alpha and jr._has_alpha
    assert ti.alpha_hops > 0  # the primaries re-traced past cut texels
    assert profiling.host_syncs["alpha_cut"] >= ti.alpha_hops
    _check_cutout(img)
    _check_matches(r, img, jr, ref)


def test_opaque_texture_disables_alpha_path():
    r, img, jr, ref = _render_pair(False, 8)
    assert not r._has_alpha and not jr._has_alpha
    assert ti.alpha_hops == profiling.host_syncs["alpha_cut"] == 0
    assert (img[..., :3].sum(-1) < 3.0).all()
    _check_matches(r, img, jr, ref)


@pytest.mark.parametrize("kernel", ["k6", "k7"])
def test_alpha_cutout_under_two_level(kernel, monkeypatch):
    """Through plain K6, and through plain K7 with K6's instance cap at 0
    (as the reference's tests force K7): the hops apply the per-instance
    material offset."""
    if kernel == "k7":
        monkeypatch.setattr(traverse_tlas, "MAX_INSTANCES", 0)
    r, img, jr, ref = _render_pair(True, 16, two_level=True)
    assert r._route.tlas == kernel and r._has_alpha
    assert jr._use_two_level and jr._has_alpha
    assert ti.alpha_hops > 0
    _check_cutout(img)
    _check_matches(r, img, jr, ref)


def test_village_flat_cull_route(monkeypatch):
    """The village row's route at a small size: textures through K2/K3's
    plain versions and the wavefront executor, against the JAX renderer's
    executor."""
    monkeypatch.setenv("RPTR_TRAVERSAL_V3", "1")
    monkeypatch.setenv("RPTR_HOST_WAVEFRONT", "1")
    sc = SceneConfig(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)
    cam = OrientedCamera.look_at([0, 4.0, 13.0], [0, 0.5, 0], fovy=55)
    r = Renderer(device="cpu")
    r.initialize(32, 32)
    r.set_scene(Scene.from_vkr_scene(tproc.village(grid=24)), scene_config=sc)
    params = RenderParams(batch_spp=1, max_path_depth=3)
    r.render(FrameConfig(camera=cam, params=params, scene_config=sc))
    assert r._route.kernel_v3 and r._wavefront is not None
    assert r._has_textures and not r._has_alpha
    img = r.readback_accumulation()

    jsc = JaxSceneConfig(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)
    fresh_jax_wavefront()
    jr = JaxRenderer()
    jr.initialize(32, 32)
    jr.set_scene(JaxScene.from_vkr_scene(jproc.village(grid=24)), scene_config=jsc)
    jr.render(JaxFrameConfig(camera=cam,
                             params=JaxRenderParams(batch_spp=1, max_path_depth=3),
                             scene_config=jsc))
    assert jr._has_textures
    assert r.last_frame_rays() == sum(int(x) for x in jr._last_rays)
    ref = np.asarray(jr.readback_accumulation())
    assert np.isfinite(img).all() and img[..., :3].mean() > 0.01
    res = goldens.compare_card(img[..., :3], ref[..., :3])
    assert res["ok"], res
