"""The ray-query and AOV entry points on the CPU, against the JAX renderer.

``Renderer.render_ray_queries`` in both modes and ``Renderer.render_aovs`` /
``readback_aov`` on four routes, each against the JAX renderer on the same
scene (which takes its XLA walks on the CPU, the oracle of every kernel):
cornell on the K1 route and on the V1 route (``RPTR_TRAVERSAL_V1``, K8's
plain version), ``procedural.terrain(grid=24)`` forced onto the streamed
route (K4's plain version) and ``procedural.instanced_field(num_inst=6)``
on the two-level route (K6's plain version).

- Closest-hit queries: 300 rays from near the camera, a third of them
  with a short per-query t_max. Triangle ids exact (source triangles; the
  global shading row on the two-level scene), u and v within 1e-4
  absolute (the reference's walks and the port's kernels round the
  barycentric dot products differently), t of a hit within 1e-5 relative.
  A miss's t is 2e32, as every kernel of both packages writes it; the
  reference's two-level XLA walk alone leaves it at the query's t_max.
- Integrator queries: the same rays through ``PT_MEGAKERNEL`` at depth 3,
  2 samples per query with the per-query t_max bounding the primary
  segment; alpha exact. The JAX renderer's ``one_sample`` is an XLA-fused
  program, so at most 2% of queries over 1e-3 (the golden gate's share),
  and a relative L1 error of at most 1e-4 (``compare_card``'s metric): on
  cornell one query that the reference leaves black reads 1.2e-5 on the
  port (an NEE sample of the area light that flips, goldens.py says why),
  which puts the per-channel mean relative error at 3e4. Measured: 1.33%
  of queries over 1e-3 and 8.9e-5 relative L1 on cornell, 5.2e-8 on the
  instanced field.
- AOVs: two passes, the second from a moved camera, so its motion AOV
  reprojects against the first view; every channel of the second pass
  within 1e-5 relative and 1e-4 absolute.
"""

import functools
import sys

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams as JaxRenderParams,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    VARIANT_MEGAKERNEL,
    VARIANT_RQ_CLOSEST,
    VARIANT_WAVEFRONT,
    FrameConfig,
)
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_v1 as tv
from realtimepathtracingresearchframework_tpu_torch.profile_frame import frame_setup

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_wavefront import _env  # noqa: E402

SIZE, DEPTH, N, SPP = 16, 3, 300, 2
ROUTES = {  # route -> (scene, frame_setup arguments, environment)
    "k1": ("cornell", {}, {}),
    "v1": ("cornell", {}, {"RPTR_TRAVERSAL_V1": "1"}),
    "streamed": ("terrain", {"grid": 24}, {"RPTR_FORCE_STREAMED_TRAVERSAL": "1"}),
    "two_level": ("instanced", {"num_inst": 6}, {}),
}
JAX_SCENES = {
    "cornell": lambda: jproc.cornell_box(),
    "terrain": lambda: jproc.terrain(grid=24),
    "instanced": lambda: jproc.instanced_field(num_inst=6),
}


def _port(route):
    scene, kw, env = ROUTES[route]
    with _env(**env):
        r, cfg = frame_setup(scene, "cpu", (SIZE, SIZE), DEPTH, **kw)
    return r, cfg


def _moved(cfg):
    """The frame config with the camera moved and turned a little."""
    pos, du, dv, tl = cfg.camera.view_basis(SIZE, SIZE)
    eye = np.asarray(pos, np.float64)
    fwd = np.asarray(tl, np.float64) + 0.5 * (np.asarray(du) + np.asarray(dv))
    cam = OrientedCamera.look_at(eye + [0.05, 0.02, 0.0],
                                 eye + 10.0 * fwd / np.linalg.norm(fwd)
                                 + [0.1, 0.0, 0.0], fovy=50)
    return FrameConfig(camera=cam, params=cfg.params, scene_config=cfg.scene_config)


def _queries(cfg):
    """N rays from around the camera into the scene, and a per-query t_max
    (short on a third of them)."""
    rng = np.random.default_rng(11)
    pos, du, dv, tl = (np.asarray(a, np.float32)
                       for a in cfg.camera.view_basis(SIZE, SIZE))
    a, b = rng.uniform(size=(2, N, 1)).astype(np.float32)
    d = tl + a * du + b * dv
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = pos + rng.uniform(-0.05, 0.05, (N, 3)).astype(np.float32)
    t_max = np.where(np.arange(N) % 3 == 0, rng.uniform(0.5, 5.0, N),
                     2.0e32).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), t_max


@functools.lru_cache(maxsize=None)
def _jax(scene):
    """The JAX renderer's answers on the scene of a route (CPU, XLA walks):
    closest queries, integrator queries, and the second of two AOV passes."""
    route = next(k for k, v in ROUTES.items() if v[0] == scene)
    _, cfg = _port(route)
    jr = jrend.Renderer()
    jr.options = jr.options.replace(use_tlas=scene == "instanced")
    jr.initialize(SIZE, SIZE)
    jr.set_scene(JaxScene.from_vkr_scene(JAX_SCENES[scene]()),
                 scene_config=cfg.scene_config)
    o, d, t_max = _queries(cfg)
    closest = jr.render_ray_queries(o, d, t_max=t_max)
    radiance = jr.render_ray_queries(o, d, t_max=t_max, variant=VARIANT_MEGAKERNEL,
                                     spp_per_query=SPP,
                                     params=JaxRenderParams(max_path_depth=DEPTH))
    aovs = []
    for c in (cfg, _moved(cfg)):
        jr.render_aovs(jrend.FrameConfig(camera=c.camera,
                                         params=JaxRenderParams(max_path_depth=DEPTH),
                                         scene_config=c.scene_config))
    aovs = [np.asarray(jr.readback_aov(k)) for k in range(3)]
    return [np.asarray(x) for x in closest], np.asarray(radiance), aovs


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_closest_queries_match_jax(route):
    r, cfg = _port(route)
    assert (r._route.v1, r._route.streamed, bool(r._route.tlas)) == (
        route == "v1", route == "streamed", route == "two_level")
    o, d, t_max = _queries(cfg)
    t, tri, u, v = r.render_ray_queries(o, d, t_max=t_max)
    jt, jtri, ju, jv = _jax(ROUTES[route][0])[0]
    assert tri.dtype == np.int32 and t.shape == (N,)
    np.testing.assert_array_equal(tri, jtri)
    hit = tri >= 0
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=0)
    assert (t[~hit] == np.float32(2.0e32)).all()
    for a, b in ((u, ju), (v, jv)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert (t_max < 1e30)[~hit].any()  # some queries end before a hit
    # RQ_CLOSEST names the same mode
    same = r.render_ray_queries(o, d, t_max=t_max, variant=VARIANT_RQ_CLOSEST)
    for a, b in zip(same, (t, tri, u, v)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_integrator_queries_match_jax(route):
    r, cfg = _port(route)
    o, d, t_max = _queries(cfg)
    res = r.render_ray_queries(o, d, t_max=t_max, variant=VARIANT_MEGAKERNEL,
                               spp_per_query=SPP,
                               params=RenderParams(max_path_depth=DEPTH))
    ref = _jax(ROUTES[route][0])[1]
    assert res.shape == ref.shape == (N, 4) and res.dtype == np.float32
    np.testing.assert_array_equal(res[:, 3], ref[:, 3])
    gate = goldens.compare_ref(res[None, :, :3], ref[None, :, :3].astype(np.float64))
    assert gate["finite"] and gate["rel_l1"] <= 1e-4, gate
    assert gate["frac_over_1e-3"] <= goldens.GOLDEN_FRAC_OVER_1E3, gate
    assert 0.2 < res[:, 3].mean() < 1.0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_aovs_match_jax(route):
    r, cfg = _port(route)
    with pytest.raises(RuntimeError, match="render_aovs"):
        r.readback_aov(r.AOV_NORMAL_DEPTH)
    first = r.render_aovs(cfg)
    assert not first.motion_jitter[..., 0:2].any()  # no motion on the first pass
    r.render_aovs(_moved(cfg))
    ref = _jax(ROUTES[route][0])[2]
    for k in (r.AOV_ALBEDO_ROUGHNESS, r.AOV_NORMAL_DEPTH, r.AOV_MOTION_JITTER):
        aov = r.readback_aov(k)
        assert aov.shape == (SIZE, SIZE, 4) and aov.dtype == np.float32
        np.testing.assert_allclose(aov, ref[k], rtol=1e-5, atol=1e-4)
    motion = r.readback_aov(r.AOV_MOTION_JITTER)[..., 0:2]
    assert np.abs(motion).max() > 1e-3


def test_integrator_queries_wavefront_on_v1(monkeypatch):
    """``PT_WAVEFRONT`` queries on the V1 route (merged K8 calls) against
    ``PT_MEGAKERNEL``'s, as tests/test_render.py:150-184 holds the
    variants: every channel within 1e-6 relative, alpha exact; an unknown
    variant raises."""
    r, cfg = _port("v1")
    o, d, t_max = _queries(cfg)
    params = RenderParams(max_path_depth=DEPTH)
    mega = r.render_ray_queries(o, d, t_max=t_max, variant=VARIANT_MEGAKERNEL,
                                spp_per_query=SPP, params=params)
    shadow_from = []
    plain = tv.plain_lanes  # what the wrappers run on CPU tensors

    def counted(bvh, rays, any_hit, first_shadow=-1):
        shadow_from.append(first_shadow)
        return plain(bvh, rays, any_hit, first_shadow)

    monkeypatch.setattr(tv, "plain_lanes", counted)
    wave = r.render_ray_queries(o, d, t_max=t_max, variant=VARIANT_WAVEFRONT,
                                spp_per_query=SPP, params=params)
    assert max(shadow_from) >= 0  # merged K8 calls
    np.testing.assert_array_equal(wave[:, 3], mega[:, 3])
    res = goldens.compare_ref(wave[None, :, :3], mega[None, :, :3].astype(np.float64))
    assert res["max_rel"] <= 1e-6, res
    with pytest.raises(ValueError, match="unknown variant"):
        r.render_ray_queries(o, d, variant="NO_SUCH_VARIANT")
