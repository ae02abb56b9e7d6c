"""Thin-lens DoF, the DEBUG_MODE_* and ray-stats images and every render
variant of the port on the CPU, against the JAX package.

- DoF primary rays: ``integrator.camera_setup`` with ``enable_dof`` against
  the reference's (integrator.py:1840-1867) under the LCG and the Sobol
  variant: origins and directions within 1e-6 relative, the RNG state after
  the aperture draw (dims 4-5) bitwise; and a DoF frame of the port's
  ``Renderer`` against the JAX renderer's (XLA) at ``goldens.compare_card``'s
  gate, ray counts equal.
- ``Renderer.render_debug_image`` in modes 1-3 (any-hit evaluations over
  the full path, of primary visibility, bounces) and
  ``Renderer.render_ray_stats`` exactly equal to the JAX renderer's run op
  by op (``jax.disable_jit``), on the alpha-cut scene of
  tests/test_alpha_test.py (a cut-out quad before an emissive wall) at
  depth 3, on the resident route (K1) and the two-level route (K6);
  ``ValueError`` under DEBUG_MODE_OFF. The JAX renderer's jitted programs
  differ from themselves run op by op on 9 of 256 pixels of mode 1 (by
  one evaluation: XLA's contracted FMAs flip whether a NEE sample from a
  point on the emissive wall traces its shadow ray), and the port equals
  the op-by-op run there.
- Every variant: ``PT``, ``PT_TAIL_RECURSIVE``, ``PT_BTD_SHADE``,
  ``PT_STACK_RECURSIVE`` and ``PT_RTP_MEGAKERNEL`` render the megakernel's
  frame bitwise; ``RT_DEBUG`` and ``GBUFFER`` the reference's
  ``_render_debug_variant`` image within 1e-5 relative (1e-4 absolute, the
  AOV tests' tolerance), as accumulation and display image.
- ``render()`` with ``options.debug_mode = 3`` renders the frame with it
  off, bitwise, as the reference's ``render`` ignores the option.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderBackendOptions as JaxOptions,
)
from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams as JaxRenderParams,
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
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RNG_VARIANT_SOBOL,
    RenderParams,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    VARIANT_GBUFFER,
    VARIANT_MEGAKERNEL,
    VARIANT_RT_DEBUG,
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models import vkr as tvkr
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.models.texture import Texture
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_alpha import CAM, _alpha_scene  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

W, H = 40, 24
DOF = dict(aperture_radius=0.08, focus_distance=2.7)
MEGAKERNEL_VARIANTS = ("PT", "PT_TAIL_RECURSIVE", "PT_BTD_SHADE",
                       "PT_STACK_RECURSIVE", "PT_RTP_MEGAKERNEL")


def _jax_cornell(rng_variant=0):
    scene, cam, params, sc = goldens.config("cornell_diffuse")
    jr = JaxRenderer()
    jr.initialize(W, H)
    jr.configure_for(JaxOptions(rng_variant=rng_variant))
    jr.set_scene(scene, scene_config=sc)
    return jr, cam


@pytest.mark.parametrize("rng_variant", [0, RNG_VARIANT_SOBOL])
def test_dof_primary_rays_match_reference(rng_variant):
    jr, cam = _jax_cornell(rng_variant)
    jcfg = jr._integrator_config(JaxRenderParams(max_path_depth=3, **DOF))
    assert jcfg.enable_dof
    tcfg = ti.IntegratorConfig(enable_dof=True, rng_variant=rng_variant)
    bufs = tps.build_rng_buffers(rng_variant)
    px, py, valid, *_ = ti.swizzle_host(W, H)
    basis = cam.view_basis(W, H)
    dims = (float(W), float(H))
    for s in (0, 5):
        jfp = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(s),
                             jnp.uint32(0),
                             aperture_radius=jnp.float32(DOF["aperture_radius"]),
                             focus_distance=jnp.float32(DOF["focus_distance"]))
        st = jps.make_state(rng_variant, jnp.uint32(s), jnp.uint32(0),
                            jnp.asarray(px), jnp.asarray(py), W,
                            bufs=jr.device_scene.rng)
        jst, jro, jrd = ji.camera_setup(
            jr.device_scene, jcfg, jfp,
            ji.ViewBuffers(*(jnp.asarray(a) for a in basis)),
            jnp.asarray(px), jnp.asarray(py), jnp.array([W, H], jnp.float32), st)
        tst = tps.make_state(rng_variant, s, 0, torch.from_numpy(px),
                             torch.from_numpy(py), W, bufs=bufs)
        tst, tro, trd = ti.camera_setup(
            tcfg, ti.ViewBuffers(*(torch.from_numpy(a) for a in basis)),
            torch.from_numpy(px), torch.from_numpy(py), dims, tst, bufs=bufs,
            fp=ti.FrameParams(sample_offset=s, **DOF))
        for port, ref in zip((*tro, *trd), (*jro, *jrd)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(port.numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(ref).max()))
        for port, ref in zip(tst, jst):
            np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))
        # the lens moved the origins
        assert float(np.abs(np.asarray(jro[0]) - basis[0][0]).max()) > 1e-3


def test_dof_frame_matches_reference():
    scene, cam, params, sc = goldens.config("cornell_diffuse")
    jr, _ = _jax_cornell()
    jp = JaxRenderParams(max_path_depth=3, **DOF)
    jr.render(JaxFrameConfig(camera=cam, params=jp, scene_config=sc), batch_spp=2)
    r = Renderer(device="cpu")
    r.initialize(W, H)
    r.set_scene(scene, scene_config=sc)
    p = RenderParams(max_path_depth=3, **DOF)
    assert r._integrator_config(p).enable_dof
    r.render(FrameConfig(camera=cam, params=p, scene_config=sc), batch_spp=2)
    assert r.last_frame_rays() == sum(int(x) for x in jr._last_rays)
    img = r.readback_accumulation()[..., :3]
    res = goldens.compare_card(img, np.asarray(jr.readback_accumulation())[..., :3])
    assert res["ok"], res
    r.render(FrameConfig(camera=cam, params=params, scene_config=sc), batch_spp=2)
    assert not np.array_equal(r.readback_accumulation()[..., :3], img)


def _alpha_pair(two_level):
    r = Renderer(device="cpu")
    r.options = r.options.replace(use_tlas=two_level)
    r.initialize(16, 16)
    r.set_scene(_alpha_scene(tproc, tvkr, Scene, Texture))
    jr = JaxRenderer()
    jr.initialize(16, 16)
    jr.configure_for(JaxOptions(use_tlas=two_level))
    jr.set_scene(_alpha_scene(jproc, jvkr, JaxScene, JaxTexture))
    assert r._has_alpha and jr._has_alpha
    return r, jr


@pytest.mark.parametrize("two_level", [False, True])
def test_debug_images_and_ray_stats_match_reference(two_level):
    r, jr = _alpha_pair(two_level)
    cfg = FrameConfig(camera=CAM, params=RenderParams(max_path_depth=3))
    jcfg = JaxFrameConfig(camera=CAM, params=JaxRenderParams(max_path_depth=3))
    with pytest.raises(ValueError, match="DEBUG_MODE_OFF"):
        r.render_debug_image(cfg)
    stats = r.render_ray_stats(cfg)
    assert stats.dtype == np.int32 and stats.shape == (16, 16)
    with jax.disable_jit():
        np.testing.assert_array_equal(stats, np.asarray(jr.render_ray_stats(jcfg)))
    images = []
    for mode in (1, 2, 3):
        r.options = r.options.replace(debug_mode=mode)
        jr.options = JaxOptions(use_tlas=two_level, debug_mode=mode)
        img = r.render_debug_image(cfg)
        assert img.dtype == np.int32 and img.shape == (16, 16)
        with jax.disable_jit():
            ref = np.asarray(jr.render_debug_image(jcfg))
        np.testing.assert_array_equal(img, ref)
        images.append(img)
    full, primary, bounces = images
    # the quad's cut texels cost evaluations on every path through them,
    # and the full path counts at least the primary visibility's
    assert primary.max() >= 1 and (full >= primary).all() and (full > primary).any()
    assert bounces.max() == 3 and bounces.min() >= 1


def _frame(variant, debug_mode=0):
    scene, cam, params, sc = goldens.config("cornell_diffuse")
    r = Renderer(device="cpu")
    r.options = r.options.replace(debug_mode=debug_mode)
    r.initialize(W, H)
    r.set_scene(scene, scene_config=sc)
    assert r.set_variant(variant)
    stats = r.render(FrameConfig(camera=cam, params=params, scene_config=sc))
    return r, stats


def test_megakernel_variants_render_the_megakernel_frame():
    ref, _ = _frame(VARIANT_MEGAKERNEL)
    want = ref.readback_accumulation()
    for name in MEGAKERNEL_VARIANTS:
        r, _ = _frame(name)
        assert np.array_equal(r.readback_accumulation(), want), name
        assert r.last_frame_rays() == ref.last_frame_rays()


@pytest.mark.parametrize("variant", [VARIANT_RT_DEBUG, VARIANT_GBUFFER])
def test_debug_variants_match_reference(variant):
    scene, cam, params, sc = goldens.config("cornell_diffuse")
    r, stats = _frame(variant)
    jr, _ = _jax_cornell()
    jr.set_variant(variant)
    jstats = jr.render(JaxFrameConfig(camera=cam, params=params, scene_config=sc))
    ref = np.asarray(jr.accum)
    assert ref.shape == (H, W, 4) and stats.spp == jstats.spp == 1
    for img in (r.readback_accumulation(), r.readback_framebuffer()):
        np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-4)
    assert r.last_frame_rays() == W * H
    # a following megakernel frame shows the path-traced image again
    r.set_variant(VARIANT_MEGAKERNEL)
    r.render(FrameConfig(camera=cam, params=params, scene_config=sc))
    assert not np.array_equal(r.readback_accumulation(), ref)


def test_render_ignores_debug_mode():
    off, _ = _frame(VARIANT_MEGAKERNEL)
    on, _ = _frame(VARIANT_MEGAKERNEL, debug_mode=3)
    assert on._integrator_config(RenderParams()).debug_mode == 0
    assert np.array_equal(on.readback_accumulation(), off.readback_accumulation())
    assert on.last_frame_rays() == off.last_frame_rays()
