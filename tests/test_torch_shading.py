"""The port's shading functions against the JAX package's, on the same
numpy inputs: BSDF sample/value/weight-pdf, tri-light and sun sampling,
the Hosek and Preetham sky, camera rays and the resolve.

Tolerance 1e-5 relative (with an absolute floor of 1e-6 for values near
zero, 1e-5 for unit-vector components): the expression order is the
reference's, but torch and XLA take transcendentals (exp, pow, atan, acos,
sin, cos) from different libm code, and XLA contracts some multiply-adds
into FMAs, so results differ in the last bits. Two places amplify those
bits and are held by the share of lanes within 1e-5 instead: the sampled
pdf, weight and MIS pdf of peaky GGX lobes (roughness below ~0.25, where
D divides by 1 + (alpha^2 - 1) cos^2(theta_h) ~ alpha^2; 99% of lanes,
and every lane whose GGX roughnesses are >= 0.3 to 1e-4), and tri-light samples from
points nearly in the light's plane (99.5% of lanes, all to 1e-3).
Discrete decisions (the sampled lobe, validity) are exact on these
inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend.params import (
    TONEMAP_MODE_FAST,
    TONEMAP_MODE_NEUTRAL,
    TONEMAP_MODE_NO,
    TONEMAP_MODE_OFF,
)
from realtimepathtracingresearchframework_tpu.models import sky as jsky
from realtimepathtracingresearchframework_tpu.ops import bsdf_gltf as jb
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import nee as jn
from realtimepathtracingresearchframework_tpu.ops import resolve as jr
from realtimepathtracingresearchframework_tpu.ops import vec3 as jv
from realtimepathtracingresearchframework_tpu_torch.models import sky as tsky
from realtimepathtracingresearchframework_tpu_torch.ops import bsdf_gltf as tb
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import nee as tn
from realtimepathtracingresearchframework_tpu_torch.ops import resolve as tres
from realtimepathtracingresearchframework_tpu_torch.ops import vec3 as tv

torch.set_num_threads(1)  # see tests/test_torch_render.py

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def close(port, ref, rtol=RTOL, atol=ATOL):
    if isinstance(port, tv.Vec3):
        for p, r in zip(port, ref):
            close(p, r, rtol, atol)
        return
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    if port.dtype == bool:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def close_frac(port, ref, frac, rtol=RTOL):
    """At least ``frac`` of the lanes agree to ``rtol``."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), ATOL)
    assert (rel <= rtol).mean() >= frac, (rel <= rtol).mean()


def _unit(rng, n=N):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _both_v(a):
    a = np.asarray(a, np.float32)
    return (jv.Vec3(*(jnp.asarray(a[:, k]) for k in range(3))),
            tv.Vec3(*(torch.from_numpy(a[:, k].copy()) for k in range(3))))


def _both(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _materials(rng, transmission, thin):
    f = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)  # noqa: E731
    base = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    strans = f(0, 1) * (rng.uniform(size=N) < 0.5) if transmission else np.zeros(N)
    ior = np.where(rng.uniform(size=N) < 0.2, 1.0, f(1.05, 2.0)).astype(np.float32)
    fields = dict(
        metallic=f(0, 1) * (rng.uniform(size=N) < 0.5),
        specular=f(0, 1), roughness=f(0.02, 1.0), ior=ior,
        specular_transmission=strans.astype(np.float32),
        onesided=rng.uniform(size=N) < 0.5,
    )
    fields = {k: np.asarray(v, np.float32 if k != "onesided" else bool)
              for k, v in fields.items()}
    tr_rough = f(0.02, 1.0) if thin else None
    bj, bt = _both_v(base)
    mj = jb.GLTFMaterial(
        base_color=bj, transmission_color=bj,
        transmission_roughness=None if tr_rough is None else jnp.asarray(tr_rough),
        **{k: jnp.asarray(v) for k, v in fields.items()},
    )
    mt = tb.GLTFMaterial(
        base_color=bt, transmission_color=bt,
        transmission_roughness=None if tr_rough is None else torch.from_numpy(tr_rough),
        **{k: torch.from_numpy(v) for k, v in fields.items()},
    )
    return mj, mt


def _frame(rng):
    n = _unit(rng)
    w_o = _unit(rng)
    w_i = _unit(rng)
    return _both_v(n), _both_v(w_o), _both_v(w_i)


MODES = [(True, False), (False, False), (True, True)]


@pytest.mark.parametrize("transmission,thin", MODES)
def test_gltf_bsdf_and_wpdf(rng, transmission, thin):
    mj, mt = _materials(rng, transmission, thin)
    (nj, nt), (oj, ot), (ij, it) = _frame(rng)
    close(tb.gltf_bsdf_v(mt, nt, ot, it, transmission, thin),
          jb.gltf_bsdf_v(mj, nj, oj, ij, transmission, thin))
    close(tb.gltf_wpdf_v(mt, nt, ot, it, transmission, thin),
          jb.gltf_wpdf_v(mj, nj, oj, ij, transmission, thin))


@pytest.mark.parametrize("transmission,thin", MODES)
def test_sample_gltf_brdf(rng, transmission, thin):
    mj, mt = _materials(rng, transmission, thin)
    (nj, nt), (oj, ot), _ = _frame(rng)
    vxj, vyj = jn.ortho_frame_v(nj)
    vxt, vyt = tn.ortho_frame_v(nt)
    close(vxt, vxj)
    close(vyt, vyj)
    u = rng.uniform(size=(4, N)).astype(np.float32)
    dj, dt = zip(*(_both(u[k]) for k in range(4)))
    wj, dirj, pdfj, misj = jb.sample_gltf_brdf_v(
        mj, nj, oj, vxj, vyj, dj[0:2], dj[2:4], transmission, thin
    )
    wt, dirt, pdft, mist = tb.sample_gltf_brdf_v(
        mt, nt, ot, vxt, vyt, dt[0:2], dt[2:4], transmission, thin
    )
    np.testing.assert_array_equal(pdft.numpy() > 0, np.asarray(pdfj) > 0)
    close(dirt, dirj, atol=1e-5)
    rough = mt.roughness.numpy() >= 0.3
    if thin:
        rough &= mt.transmission_roughness.numpy() >= 0.3
    for port, ref in ((pdft, pdfj), (mist, misj), *zip(wt, wj)):
        port, ref = port.numpy(), np.asarray(ref)
        close(port[rough], ref[rough], rtol=1e-4)
        close_frac(port, ref, 0.99)


def test_sample_tri_lights(rng):
    nl = 7
    v0 = rng.uniform(-1, 1, (nl, 3)).astype(np.float32)
    v0[:, 1] += 2.0
    v1 = v0 + rng.uniform(-0.5, 0.5, (nl, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (nl, 3)).astype(np.float32)
    rad = rng.uniform(0, 5, (nl, 3)).astype(np.float32)
    lj = jn.TriLightBuffers(*(jnp.asarray(a) for a in (v0, v1, v2, rad)))
    lt = tn.light_buffers(v0, v1, v2, rad, "cpu")
    p = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    (pj, pt), (nj, nt) = _both_v(p), _both_v(_unit(rng))
    u = rng.uniform(size=(4, N)).astype(np.float32)
    dj, dt = zip(*(_both(u[k]) for k in range(4)))
    sj = jn.sample_tri_lights_v(lj, pj, nj, dj[0:2], dj[2:4], 16, False)
    st = tn.sample_tri_lights_v(lt, pt, nt, dt[0:2], dt[2:4])
    close(st.dir, sj.dir, atol=1e-5)
    for f in ("illum", "dist", "pdf", "mis_wpdf"):
        for port, ref in zip(*(
            (x,) if not isinstance(x, (tv.Vec3, jv.Vec3)) else tuple(x)
            for x in (getattr(st, f), getattr(sj, f))
        )):
            close(port, ref, rtol=1e-3)
            close_frac(port, ref, 0.995)
    # binned RIS selection over the 7 lights in one bin (tests/
    # test_torch_ris.py holds it on several bins and the light ids)
    sj = jn.sample_tri_lights_v(lj, pj, nj, dj[0:2], dj[2:4], nl, True)
    st = tn.sample_tri_lights_v(lt, pt, nt, dt[0:2], dt[2:4], nl, True)
    close(st.dir, sj.dir, atol=1e-5)
    for f in ("illum", "dist", "pdf", "mis_wpdf"):
        for port, ref in zip(*(
            (x,) if not isinstance(x, (tv.Vec3, jv.Vec3)) else tuple(x)
            for x in (getattr(st, f), getattr(sj, f))
        )):
            close(port, ref, rtol=1e-3)
            close_frac(port, ref, 0.995)


def test_sun_sampling_and_mis(rng):
    sd = np.float32([0.3, 0.8, 0.2])
    sd /= np.linalg.norm(sd)
    cos_r = np.float32(np.cos(np.radians(0.53) / 2))
    u = rng.uniform(size=(2, N)).astype(np.float32)
    close(
        tn.sample_sun_dir_v(torch.from_numpy(sd), torch.tensor(cos_r),
                            torch.from_numpy(u[0]), torch.from_numpy(u[1])),
        jn.sample_sun_dir_v(jnp.asarray(sd), jnp.float32(cos_r),
                            jnp.asarray(u[0]), jnp.asarray(u[1])),
    )
    a, b = rng.uniform(0, 10, (2, N)).astype(np.float32)
    close(tn.nee_mis_heuristic(1.0, torch.from_numpy(a), 1.0, torch.from_numpy(b)),
          jn.nee_mis_heuristic(1.0, jnp.asarray(a), 1.0, jnp.asarray(b)))


@pytest.mark.parametrize("model,sun", [("hosek", (0.3, 0.8, 0.2)),
                                       ("hosek", (0.0, 1.0, 0.0)),
                                       ("preetham", (0.35, 0.8, 0.3))])
def test_sky_radiance(rng, model, sun):
    pj = jsky.build_sky(sun, 3.0, model=model)
    pt = tsky.build_sky(sun, 3.0, model=model)
    for f in tsky.SkyParams._fields:
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)))
    dj, dt = _both_v(_unit(rng))
    close(tsky.sky_radiance_v(pt, dt), jsky.sky_radiance_v(pj, dj), rtol=2e-5)


def test_camera_rays(rng):
    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera,
    )

    w, h = 192, 108
    basis = OrientedCamera.look_at([0, 1.0, 3.2], [0.2, 1.0, 0.0], fovy=50).view_basis(w, h)
    px = rng.integers(0, w, N).astype(np.int32)
    py = rng.integers(0, h, N).astype(np.int32)
    j = rng.uniform(size=(2, N)).astype(np.float32)
    roj, rdj = ji.camera_rays_v(
        ji.ViewBuffers(*(jnp.asarray(a) for a in basis)), jnp.asarray(px),
        jnp.asarray(py), jnp.array([w, h], jnp.float32), jnp.asarray(j[0]),
        jnp.asarray(j[1]),
    )
    rot, rdt = ti.camera_rays_v(
        ti.ViewBuffers(*(torch.from_numpy(a) for a in basis)),
        torch.from_numpy(px), torch.from_numpy(py), (float(w), float(h)),
        torch.from_numpy(j[0]), torch.from_numpy(j[1]),
    )
    close(rot, roj, rtol=0, atol=0)
    close(rdt, rdj)


@pytest.mark.parametrize("pixel_radius", [1.0, 2.5])
def test_camera_footprint0(rng, pixel_radius):
    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera,
    )

    w, h = 192, 108
    basis = OrientedCamera.look_at([0, 1.0, 3.2], [0.2, 1.0, 0.0], fovy=50).view_basis(w, h)
    rdj, rdt = _both_v(_unit(rng))
    fj = ji.camera_footprint0(
        ji.IntegratorConfig(has_textures=True),
        ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(0), jnp.uint32(0),
                       pixel_radius=jnp.float32(pixel_radius)),
        ji.ViewBuffers(*(jnp.asarray(a) for a in basis)),
        jnp.array([w, h], jnp.float32), rdj,
    )
    view = ti.ViewBuffers(*(torch.from_numpy(a) for a in basis))
    fp = ti.FrameParams(pixel_radius=pixel_radius)
    ft = ti.camera_footprint0(ti.IntegratorConfig(has_textures=True), fp, view,
                              (float(w), float(h)), rdt)
    for port, ref in zip(ft, fj):
        close(port, ref, atol=1e-12)
    assert ti.camera_footprint0(ti.IntegratorConfig(), fp, view,
                                (float(w), float(h)), rdt) is None


@pytest.mark.parametrize("tonemap", [TONEMAP_MODE_OFF, TONEMAP_MODE_NO,
                                     TONEMAP_MODE_NEUTRAL, TONEMAP_MODE_FAST])
def test_resolve_channels(rng, tonemap):
    ch = rng.uniform(0, 4, (4, N)).astype(np.float32)
    ch[:, :16] = 0.0
    outj = jr.resolve_channels(tuple(jnp.asarray(c) for c in ch), jnp.float32(0.5),
                               tonemap)
    outt = tres.resolve_channels(tuple(torch.from_numpy(c) for c in ch), 0.5,
                                 tonemap)
    for p, r in zip(outt, outj):
        close(p, r)


def test_nee_candidate_drops_non_finite_samples(rng, monkeypatch):
    """A light sample whose pdfs overflow (a triangle seen edge-on from a
    point in its own plane: the reference's contribution is NaN there) is
    dropped: no contribution and no shadow ray; every other lane keeps its
    candidate unchanged."""
    from types import SimpleNamespace

    n = 256
    v0 = np.array([[0.0, 2.0, 0.0]], np.float32)
    lt = tn.light_buffers(v0, v0 + [[1.0, 0.0, 0.0]], v0 + [[0.0, 0.0, 1.0]],
                          np.full((1, 3), 4.0, np.float32), "cpu")
    ds = SimpleNamespace(lights=lt, sky=tsky.build_sky((0.3, 0.8, 0.2), 3.0, (0.1, 0.1, 0.1),
                                                       has_area_lights=True))
    cfg = ti.IntegratorConfig(num_lights=1)
    _, mt = _materials(rng, True, False)
    mt = tb.GLTFMaterial(*(f[:n] if isinstance(f, torch.Tensor) else
                           (tv.Vec3(*(c[:n] for c in f)) if isinstance(f, tv.Vec3) else f)
                           for f in mt))
    p = tv.Vec3(*(torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
                  for _ in range(3)))
    up = tv.Vec3(torch.zeros(n), torch.ones(n), torch.zeros(n))
    w_o = tv.Vec3(*(torch.from_numpy(c.copy()) for c in _unit(rng, n).T))
    w_o = tv.Vec3(w_o.x, w_o.y.abs(), w_o.z)
    u = [torch.from_numpy(rng.uniform(size=n).astype(np.float32)) for _ in range(3)]
    sel = (torch.ones(n), u[2])  # every lane samples the area light
    args = (ds, cfg, p, up, up, mt, w_o, (u[0], u[1]), sel, torch.zeros(n))
    ref = ti._nee_candidate(*args)
    sample = tn.sample_tri_lights_v
    broken = torch.arange(n) % 4 == 0

    def overflow(*a, **k):
        s = sample(*a, **k)
        return s._replace(mis_wpdf=torch.where(broken, float("inf"), s.mis_wpdf))

    monkeypatch.setattr(tn, "sample_tri_lights_v", overflow)
    got = ti._nee_candidate(*args)
    assert ref.traced[broken].any()
    assert not got.traced[broken].any() and not got.uncond[broken].any()
    for c in got.contrib:
        assert torch.isfinite(c).all() and (c[broken] == 0).all()
    for a, b in zip((*got.contrib, got.traced, got.uncond),
                    (*ref.contrib, ref.traced, ref.uncond)):
        assert torch.equal(a[~broken], b[~broken])
    assert torch.equal(got.dropped, broken & (ref.traced | ref.uncond))
    # the callers count the dropped samples of their active lanes
    ti.reset_nee_dropped()
    active = torch.arange(n) % 8 != 0
    ti._count_nee_dropped(got.dropped & active)
    ti._count_nee_dropped(got.dropped & active)
    assert ti.nee_dropped() == 2 * int((got.dropped & active).sum()) > 0
    ti.reset_nee_dropped()
    assert ti.nee_dropped() == 0


# The village lane whose NEE sample went NaN on an H100 (pixel (1488, 439)
# of the 1080p frame, sample 3, the vertex of bounce 1 on a window light):
# the card's hit point, normals, w_o and path length as logged there, the
# CPU's for the same lane (a few ulps away), and the lane's LCG draws.
_VILLAGE_LANE = {
    "card": dict(
        p=(7.507884502410889, 1.3789480924606323, -0.5721555948257446),
        n=(-4.094379983143881e-05, 0.8944491147994995, -0.4471699893474579),
        gn=(-4.108785287826322e-05, 0.8944414258003235, -0.44718509912490845),
        w_o=(-0.6359391808509827, 0.49052754044532776, -0.5957887768745422),
        total_t=16.37977409362793),
    "cpu": dict(
        p=(7.5078816413879395, 1.3789469003677368, -0.5721580982208252),
        n=(-4.094379619346e-05, 0.8944490551948547, -0.4471699595451355),
        gn=(-4.108785287826322e-05, 0.8944414258003235, -0.44718509912490845),
        w_o=(-0.6359387636184692, 0.4905308783054352, -0.5957863926887512),
        total_t=16.379770278930664),
}
_VILLAGE_DRAWS = dict(dir=(0.3150511384010315, 0.7388033270835876),
                      sel=(0.8673349022865295, 0.9057645797729492))


@pytest.mark.parametrize("inputs", ["card", "cpu"])
def test_nee_candidate_replays_the_village_lane(inputs):
    """The reference's _nee_candidate on the card's inputs: the sampled
    window-light triangle lies nearly in the vertex's plane, its distance
    and MIS pdf overflow and the balance heuristic gives inf / inf = NaN,
    with a shadow ray traced. The port computes the same light sample and
    drops that candidate (no contribution, no shadow ray, counted). On the
    CPU's inputs both reject the candidate (strict normals) alike."""
    from types import SimpleNamespace

    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    r, fc = frame_setup("village", "cpu", (8, 8), 2)
    cfg = r._integrator_config(fc.params)
    sky, lights = r.device_scene.sky, r.device_scene.lights
    rcfg = ji.IntegratorConfig(
        num_lights=cfg.num_lights, light_bin_size=cfg.light_bin_size,
        use_light_bins=cfg.use_light_bins, has_transmission=cfg.has_transmission,
        thin_transmission=cfg.thin_transmission)
    rds = SimpleNamespace(
        sky=SimpleNamespace(sun_radiance=jnp.asarray(sky.sun_radiance.numpy()),
                            sun_dir=jnp.asarray(sky.sun_dir.numpy()),
                            sun_cos_angle=jnp.float32(sky.sun_cos_angle)),
        lights=jn.TriLightBuffers(*(
            jnp.asarray(torch.stack(tuple(col), 1).numpy())
            for col in (lights.v0, lights.v1, lights.v2, lights.radiance))))
    lane = _VILLAGE_LANE[inputs]
    (pj, pt), (nj, nt), (gj, gt), (wj, wt) = (
        _both_v([lane[k]]) for k in ("p", "n", "gn", "w_o"))
    tj, tt = _both(np.float32([lane["total_t"]]))
    dj, dt = zip(*(_both(np.float32([u])) for u in _VILLAGE_DRAWS["dir"]))
    sj, st = zip(*(_both(np.float32([u])) for u in _VILLAGE_DRAWS["sel"]))
    # the material there as logged: procedural.village's window emitter
    base = np.float32([[1.0, 0.85, 0.6]])
    bj, bt = _both_v(base)
    fields = dict(metallic=0.0, specular=0.5, roughness=0.49803921580314636,
                  ior=1.5, specular_transmission=0.0)
    mj = jb.GLTFMaterial(base_color=bj, transmission_color=bj,
                         onesided=jnp.asarray([False]),
                         **{k: jnp.float32([v]) for k, v in fields.items()})
    mt = tb.GLTFMaterial(base_color=bt, transmission_color=bt,
                         onesided=torch.tensor([False]),
                         **{k: torch.tensor([v]) for k, v in fields.items()})
    ref = ji._nee_candidate(rds, rcfg, pj, nj, gj, mj, wj, dj, sj, tj)
    got = ti._nee_candidate(SimpleNamespace(sky=sky, lights=lights), cfg, pt,
                            nt, gt, mt, wt, dt, st, tt)
    sun_w = float(sky.sun_radiance[3])
    sel2 = (np.clip((np.float32(_VILLAGE_DRAWS["sel"][0]) - sun_w) / (1 - sun_w),
                    0, 1).astype(np.float32), np.float32(_VILLAGE_DRAWS["sel"][1]))
    ls_j = jn.sample_tri_lights_v(rds.lights, pj, nj, dj,
                                  tuple(jnp.float32([u]) for u in sel2),
                                  cfg.light_bin_size, False)
    ls_t = tn.sample_tri_lights_v(lights, pt, nt, dt,
                                  tuple(torch.tensor([u]) for u in sel2))
    for a, b in ((ls_t.pdf, ls_j.pdf), (ls_t.mis_wpdf, ls_j.mis_wpdf),
                 (ls_t.dist, ls_j.dist), *zip(ls_t.dir, ls_j.dir)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if inputs == "card":
        assert np.isinf(np.asarray(ls_j.mis_wpdf)).all()
        assert all(np.isnan(np.asarray(c)).all() for c in ref.contrib)
        assert bool(ref.traced[0])
        assert bool(got.dropped[0]) and not bool(got.traced[0] | got.uncond[0])
        assert all(float(c[0]) == 0.0 for c in got.contrib)
    else:
        for a, b in ((got.traced, ref.traced), (got.uncond, ref.uncond)):
            assert not bool(a[0]) and not bool(b[0])
        assert not bool(got.dropped[0])
        for c, d in zip(got.contrib, ref.contrib):
            assert float(c[0]) == float(d[0]) == 0.0
