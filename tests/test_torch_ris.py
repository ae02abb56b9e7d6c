"""Binned RIS light selection on the CPU, against the JAX package.

- ``ops/nee.py::sample_tri_lights_v`` with ``use_bins`` against the
  reference's (nee.py:161-310) on random hit points, normals and light
  tables of one, four and eight bins: the picked light of every lane equal
  (read back from the sample, each light's radiance an integer multiple of
  one colour), and every output within 1e-5 relative (the scores' sum and
  CDF add in a different order than XLA's; ``approx_tri_lights_pdf``
  exactly).
- Frames under the RIS variant: cornell and a small village at 64x36,
  depth 3, 2 samples, through the port's ``Renderer`` (the binned-lights
  payload of ``set_scene``: ``equalize_emitter_bins`` at a bin width of
  min(bucket count, emitter count)) against the JAX renderer's device scene
  and integrator run op by op (``jax.disable_jit``), at the gates that
  ``goldens.compare_ref`` uses for the RNG goldens (``goldens.L1_GATED``):
  at most 1% of pixels over 1e-3 relative, and a relative L1 error of at
  most 1e-4 in the mean relative error's place, for the reason given
  there: the reference leaves a few pixels at exactly 0.0 that one of the
  port's samples lights with ~1e-5, or the other way round, and each such
  pixel's relative error is ~1e7 (measured on cornell: 3 of 2,304 pixels,
  mean relative error 4.5e3, relative L1 7.4e-6, 0.22% of pixels over
  1e-3). The scores' sum and CDF add in another order than XLA's, so a
  lane whose selection sample lies within an ulp of a CDF step picks the
  next light. Ray counts per sample are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderBackendOptions as JaxOptions,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    Renderer as JaxRenderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import nee as jn
from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu.ops import vec3 as jv
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    LIGHT_SAMPLING_VARIANT_RIS,
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import nee as tn
from realtimepathtracingresearchframework_tpu_torch.ops import vec3 as tv

torch.set_num_threads(1)  # see tests/test_torch_render.py

N = 4096
W, H = 64, 36
SPP = 2


def _vec(a):
    """(N, 3) numpy -> (JAX Vec3, torch Vec3)."""
    return (jv.Vec3(*(jnp.asarray(a[:, k]) for k in range(3))),
            tv.Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                      for k in range(3))))


def _ids(sample):
    """The light each lane picked: light k has radiance (k + 1) x (1, 0.5,
    0.25), so illum x pdf reads k + 1 where the sample is not degenerate;
    -1 where it is."""
    x = np.asarray(sample.illum[0], np.float64) * np.asarray(sample.pdf, np.float64)
    return np.where(np.asarray(sample.pdf) > 0.0, np.rint(x) - 1, -1).astype(int)


@pytest.mark.parametrize("bins", [1, 4, 8])
def test_ris_selection_matches_reference(rng, bins):
    bin_size = 8
    nl = bins * bin_size
    v0 = rng.uniform(-2, 2, (nl, 3)).astype(np.float32)
    v0[:, 1] += 3.0
    v1 = v0 + rng.uniform(-0.6, 0.6, (nl, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.6, 0.6, (nl, 3)).astype(np.float32)
    rad = (np.arange(1, nl + 1, dtype=np.float32)[:, None]
           * np.float32([1.0, 0.5, 0.25]))
    lj = jn.TriLightBuffers(*(jnp.asarray(a) for a in (v0, v1, v2, rad)))
    lt = tn.light_buffers(v0, v1, v2, rad, "cpu")
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    n = rng.normal(size=(N, 3))
    n[:, 1] = np.abs(n[:, 1])  # most lights lie above the points
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    (pj, pt), (nj, nt) = _vec(p), _vec(n)
    u = rng.uniform(size=(4, N)).astype(np.float32)
    uj = [jnp.asarray(x) for x in u]
    ut = [torch.from_numpy(x) for x in u]
    sj = jn.sample_tri_lights_v(lj, pj, nj, uj[0:2], uj[2:4], bin_size, True)
    st = tn.sample_tri_lights_v(lt, pt, nt, ut[0:2], ut[2:4], bin_size, True)
    ids = _ids(st)
    np.testing.assert_array_equal(ids, _ids(sj))
    assert (ids >= 0).mean() > 0.9 and len(np.unique(ids[ids >= 0])) > nl // 2
    for f in ("illum", "dir", "dist", "pdf", "mis_wpdf"):
        port, ref = getattr(st, f), getattr(sj, f)
        pairs = zip(port, ref) if isinstance(port, tv.Vec3) else [(port, ref)]
        for a, b in pairs:
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))
    sa = rng.uniform(0, 0.5, N).astype(np.float32)
    np.testing.assert_array_equal(
        tn.approx_tri_lights_pdf(torch.from_numpy(sa), nl, bins, True).numpy(),
        np.asarray(jn.approx_tri_lights_pdf(jnp.asarray(sa), nl, bins, True)))


SCENES = {
    "cornell": lambda proc: proc.cornell_box(),
    "village": lambda proc: proc.village(grid=8),
}
VILLAGE_SC = dict(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)


def _setup(name):
    """(camera, scene config kwargs) of a scene."""
    if name == "cornell":
        return goldens.config("cornell_diffuse")[1], {}
    return OrientedCamera.look_at([0, 4.0, 13.0], [0, 0.5, 0], fovy=55), VILLAGE_SC


def _port(name, buckets):
    cam, sc = _setup(name)
    sc = SceneConfig(**sc)
    r = Renderer(device="cpu")
    r.options = r.options.replace(light_sampling_variant=LIGHT_SAMPLING_VARIANT_RIS,
                                  light_sampling_bucket_count=buckets)
    r.initialize(W, H)
    r.set_scene(Scene.from_vkr_scene(SCENES[name](tproc)), scene_config=sc)
    params = RenderParams(max_path_depth=3)
    rays = []
    for _ in range(SPP):
        r.render(FrameConfig(camera=cam, params=params, scene_config=sc),
                 batch_spp=1)
        rays.append(r.last_frame_rays())
    return r, r.readback_accumulation()[..., :3], rays


def _jax_op_by_op(name, buckets):
    """The frame through the JAX renderer's device scene and integrator,
    run op by op: (H, W, 3) mean of SPP samples, rays per sample, the
    renderer."""
    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderParams as JaxParams,
    )
    from realtimepathtracingresearchframework_tpu.backend.params import (
        SceneConfig as JaxSceneConfig,
    )

    cam, sc = _setup(name)
    jr = JaxRenderer()
    jr.initialize(W, H)
    jr.configure_for(JaxOptions(light_sampling_variant=LIGHT_SAMPLING_VARIANT_RIS,
                                light_sampling_bucket_count=buckets))
    jr.set_scene(JaxScene.from_vkr_scene(SCENES[name](jproc)),
                 scene_config=JaxSceneConfig(**sc))
    jds = jr.device_scene
    jcfg = jr._integrator_config(JaxParams(max_path_depth=3))
    px, py, valid, *_ = ti.swizzle_host(W, H)
    view = ji.ViewBuffers(*(jnp.asarray(a) for a in cam.view_basis(W, H)))
    img, rays = 0.0, []
    with jax.disable_jit():
        for s in range(SPP):
            fp = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(s),
                                jnp.uint32(0))
            st = jps.make_state(jcfg.rng_variant, jnp.uint32(s), jnp.uint32(0),
                                jnp.asarray(px), jnp.asarray(py), W,
                                bufs=jds.rng)
            st, ro, rd = ji.camera_setup(jds, jcfg, fp, view, jnp.asarray(px),
                                         jnp.asarray(py),
                                         jnp.array([W, H], jnp.float32), st)
            foot = ji.camera_footprint0(jcfg, fp, view,
                                        jnp.array([W, H], jnp.float32), rd)
            rgb, _, nr = ji.trace_paths(jds, jcfg, fp, ro, rd, st,
                                        lane_mask=jnp.asarray(valid),
                                        footprint0=foot)
            rays.append(int(np.asarray(nr)[valid].sum()))
            img = img + np.stack([np.asarray(c) for c in rgb], -1) / SPP
    out = np.zeros((H, W, 3), np.float32)
    out[py[valid], px[valid]] = img[valid]
    return out, rays, jr


@pytest.mark.parametrize("name,buckets", [("cornell", 16), ("village", 4)])
def test_ris_frames_match_reference(name, buckets):
    r, img, rays = _port(name, buckets)
    ref, jrays, jr = _jax_op_by_op(name, buckets)
    cfg = r._integrator_config(RenderParams(max_path_depth=3))
    assert cfg.use_light_bins and jr._use_bins
    assert cfg.light_bin_size == jr._effective_bin_size
    assert r._num_lights == jr._num_lights and r._num_lights % cfg.light_bin_size == 0
    assert rays == jrays
    assert img.mean() > 1e-3
    res = goldens.compare_ref(img, ref)
    assert res["finite"], res
    assert res["frac_over_1e-3"] <= goldens.REF_FRAC_OVER_1E3, res
    assert res["rel_l1"] <= goldens.REF_MEAN_REL, res
