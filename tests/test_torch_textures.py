"""The port's textured scenes on the CPU, against the JAX package.

- The atlas: ``build_atlas`` texels and descriptors bitwise the
  reference's, on the village's textures (which the port's copy of
  ``procedural.village`` makes bitwise the reference's, mips included) and
  on sRGB and linear textures of other sizes; the village's attribute and
  material tables bitwise the reference's (the texture columns included).
- ``sample_atlas`` and ``sample_atlas_aniso`` at random uv, mips and
  footprints, sRGB decode included, against the reference run op by op:
  1e-6 relative (the reference's sRGB ``**`` and the port's ``torch.pow``
  may differ in the last bit).
- The footprint functions (``camera_footprint0``, the eigen-decomposition
  and the reflection) at 1e-6 per lane, relative to the lane's largest
  component; the eigen-decomposition, whose small eigenvalue cancels, at
  1e-5 of the larger differential vector.
- The three texture cases of ``tests/test_textures.py:59-153`` on the port:
  the checkered floor against the JAX renderer (XLA-fused there, so the
  gate is ``goldens.compare_ref``'s), the anisotropic sampler against its
  manual taps, and an anisotropic render finite, close in energy to the
  isotropic one, different from it and near the JAX renderer's.
- The golden ``cornell_textured`` against the JAX package run op by op
  (ray counts per lane exact, radiance at the golden's ``compare_ref``
  gate) and against ``tests/goldens/cornell_textured.pfm``
  (``goldens.compare``); ``goldens.py`` says why its share of pixels over
  1e-3 is 2% and 3% there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.models.texture import (
    Texture as JaxTexture,
)
from realtimepathtracingresearchframework_tpu.models.texture import (
    build_mip_chain as jax_mip_chain,
)
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu.ops import texture_atlas as jta
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.models.texture import (
    Texture,
    build_mip_chain,
)
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import shade_common as tsc
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import texture_atlas as tta
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

torch.set_num_threads(1)  # see tests/test_torch_render.py


def _u8_checker(n=16, c0=(255, 0, 0, 255), c1=(0, 0, 255, 255)):
    """tests/test_textures.py:19-25."""
    img = np.zeros((n, n, 4), np.uint8)
    yy, xx = np.mgrid[0:n, 0:n]
    mask = ((xx // 4 + yy // 4) % 2).astype(bool)
    img[mask] = c0
    img[~mask] = c1
    return img


def _noise_textures(mod_tex, mod_mips):
    """sRGB and linear textures of several sizes, some with partial mip
    chains, from one seed."""
    rng = np.random.default_rng(11)
    out = []
    for k, (h, w) in enumerate(((8, 8), (32, 16), (4, 64), (1, 1))):
        img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        mips = mod_mips(img) if h > 1 else [img]
        if k == 2:
            mips = mips[:3]
        out.append(mod_tex(w, h, 37, mips=mips, srgb=k % 2 == 0))
    return out


def _textures(name):
    """(reference textures, port textures) of a case."""
    if name == "village":
        jt = JaxScene.from_vkr_scene(jproc.village(grid=20)).textures
        tt = Scene.from_vkr_scene(tproc.village(grid=20)).textures
        return jt, tt
    return (_noise_textures(JaxTexture, jax_mip_chain),
            _noise_textures(Texture, build_mip_chain))


@pytest.mark.parametrize("name", ["village", "noise"])
def test_build_atlas_matches(name):
    jt, tt = _textures(name)
    assert len(jt) == len(tt) > 0
    for a, b in zip(jt, tt):
        assert a.srgb == b.srgb and len(a.mips) == len(b.mips)
        for ma, mb in zip(a.mips, b.mips):
            np.testing.assert_array_equal(ma, mb)
    ref = jta.build_atlas(jt)
    port = tta.build_atlas(tt)
    np.testing.assert_array_equal(port.texels.numpy().view(np.uint32),
                                  np.asarray(ref.texels))
    np.testing.assert_array_equal(port.desc.numpy(), np.asarray(ref.desc))
    np.testing.assert_array_equal(port.num_mips.numpy(), np.asarray(ref.num_mips))
    np.testing.assert_array_equal(port.srgb.numpy(), np.asarray(ref.srgb))
    assert port.texels.dtype == torch.int32


def test_scene_tables_match():
    """The village's attribute rows (uv0-2, tangent, texel density among
    them) and material rows, packed by the port and by the reference: the
    same columns, bitwise."""
    jflat = JaxScene.from_vkr_scene(jproc.village(grid=20))
    tscene = Scene.from_vkr_scene(tproc.village(grid=20))
    jf, tf_ = jflat.flatten_world(), tscene.flatten_world()
    ref = np.asarray(ji.pack_attr_table(jf, jf))
    port = ti.pack_attr_table(tf_, tf_).numpy()
    np.testing.assert_array_equal(port, ref)
    assert np.abs(port[tsc._A_UV0:tsc._A_DENS + 1]).max() > 0
    ref = np.asarray(ji.pack_material_table(jflat.material_table()))
    port = ti.pack_material_table(tscene.material_table()).numpy()
    np.testing.assert_array_equal(port, ref)
    assert (port[tsc._M_BCTEX] >= 0).any() and (port[tsc._M_NMTEX] >= 0).any()


def _atlases():
    jt, tt = _textures("noise")
    vj, vt = _textures("village")
    return jta.build_atlas(jt + vj), tta.build_atlas(tt + vt)


def test_sample_atlas_matches():
    """Random texture ids, uv in [-2, 3) (wrap addressing both ways) and
    mip levels in [-1, 15) (clamped both ways), sRGB and linear."""
    ja, ta = _atlases()
    rng = np.random.default_rng(3)
    n = 4096
    tid = rng.integers(0, ta.count, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    mip = rng.uniform(-1.0, 15.0, n).astype(np.float32)
    ref = np.asarray(jta.sample_atlas(ja, jnp.asarray(tid), jnp.asarray(uv),
                                      jnp.asarray(mip)))
    port = tta.sample_atlas(ta, torch.from_numpy(tid), torch.from_numpy(uv),
                            torch.from_numpy(mip)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-7)
    srgb = ta.srgb.numpy()[tid]
    assert srgb.any() and (~srgb).any()


def test_sample_atlas_aniso_matches():
    ja, ta = _atlases()
    rng = np.random.default_rng(4)
    n = 2048
    tid = rng.integers(0, ta.count, n).astype(np.int32)
    uv = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    dx = (rng.normal(size=(n, 2)) * rng.uniform(0, 0.3, (n, 1))).astype(np.float32)
    dy = (rng.normal(size=(n, 2)) * rng.uniform(0, 0.05, (n, 1))).astype(np.float32)
    for taps in (1, 4):
        ref = np.asarray(jta.sample_atlas_aniso(
            ja, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(dx),
            jnp.asarray(dy), taps))
        port = tta.sample_atlas_aniso(
            ta, torch.from_numpy(tid), torch.from_numpy(uv), torch.from_numpy(dx),
            torch.from_numpy(dy), taps).numpy()
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-7)


def _vec(rng, n, unit=True):
    a = rng.normal(size=(n, 3)).astype(np.float32)
    if unit:
        a /= np.linalg.norm(a, axis=-1, keepdims=True)
    return a


def test_footprint_functions_match():
    rng = np.random.default_rng(5)
    n = 1024
    rd, wi = _vec(rng, n), _vec(rng, n)
    dpdx, dpdy = _vec(rng, n, False) * 1e-3, _vec(rng, n, False) * 1e-3

    def jv(a):
        return ji.Vec3(*(jnp.asarray(a[:, k]) for k in range(3)))

    def tv(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))

    worst = []

    def close(port, ref, tol=1e-6):
        # per lane, relative to the lane's largest component: a component
        # that cancels to near zero keeps only the absolute error of its
        # terms
        p = np.stack([x.numpy() for x in port], -1).astype(np.float64)
        r = np.stack([np.asarray(x) for x in ref], -1).astype(np.float64)
        err = np.abs(p - r).max(-1) / np.maximum(np.abs(r).max(-1), 1e-30)
        worst.append(float(err.max()))
        assert err.max() <= tol, worst

    with jax.disable_jit():
        fj = ji._dpdxy_to_footprint_v(jv(rd), jv(dpdx), jv(dpdy))
        dj = ji._footprint_to_dpdxy_v(jv(rd), *fj)
        rj = ji._reflect_footprint_v(jv(wi), jv(rd), *fj)
    ft = tsc._dpdxy_to_footprint_v(tv(rd), tv(dpdx), tv(dpdy))
    close(ft, fj)
    # the rest from the reference's own footprint, so each function is
    # held on its own
    fjt = [torch.from_numpy(np.array(f)) for f in fj]
    dt = tsc._footprint_to_dpdxy_v(tv(rd), *fjt)
    # the two differential vectors together: the small eigenvalue
    # 0.5 B - D cancels, so its vector is held to the footprint's scale,
    # at 1e-5 (measured 3.3e-6)
    close((*dt[0], *dt[1]), (*dj[0], *dj[1]), 1e-5)
    close(tsc._reflect_footprint_v(tv(wi), tv(rd), *fjt), rj)

    # the camera footprint of a 48x36 frame
    cam = OrientedCamera.look_at([0, 1.4, 3.0], [0, 0.2, 0.0], fovy=60)
    basis = cam.view_basis(48, 36)
    cfg_t = ti.IntegratorConfig(has_textures=True)
    cfg_j = ji.IntegratorConfig(has_textures=True)
    fp_j = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(0), jnp.uint32(0),
                          pixel_radius=jnp.float32(1.5))
    with jax.disable_jit():
        cj = ji.camera_footprint0(cfg_j, fp_j, ji.ViewBuffers(
            *(jnp.asarray(a) for a in basis)), jnp.array([48, 36], jnp.float32),
            jv(rd))
    # the isotropic mip of a world footprint and a texel density (log2 of
    # two libraries: the last bit may differ)
    fw = rng.uniform(0.0, 0.05, n).astype(np.float32)
    tpw = rng.uniform(0.0, 4096.0, n).astype(np.float32)
    np.testing.assert_allclose(
        tta.footprint_mip(torch.from_numpy(fw), torch.from_numpy(tpw)).numpy(),
        np.asarray(jta.footprint_mip(jnp.asarray(fw), jnp.asarray(tpw))),
        rtol=1e-6, atol=1e-6)
    ct = ti.camera_footprint0(cfg_t, ti.FrameParams(pixel_radius=1.5),
                              ti.ViewBuffers(*(torch.from_numpy(a) for a in basis)),
                              (48.0, 36.0), tv(rd))
    close(ct, cj)
    assert ti.camera_footprint0(ti.IntegratorConfig(), ti.FrameParams(), None,
                                (48.0, 36.0), tv(rd)) is None


def _floor_scene(mod, tex_cls, mips):
    sv = mod.cornell_box()
    sv.materials[0].tex_base_color = tex_cls(
        16, 16, 37, mips=mips(_u8_checker()), srgb=False)
    return sv


FLOOR_CAM = OrientedCamera.look_at([0, 1.4, 3.0], [0, 0.2, 0.0], fovy=60)


def test_textured_floor_renders():
    """tests/test_textures.py:59-79 on the port, against the JAX renderer:
    the same ray count, strong red/blue variation on the floor, and the
    radiance at the textured golden's ``compare_ref`` gate."""
    r = Renderer(device="cpu")
    r.initialize(32, 32)
    scene = Scene.from_vkr_scene(_floor_scene(tproc, Texture, build_mip_chain))
    assert scene.total_texture_bytes > 0
    r.set_scene(scene)
    assert r._has_textures and r.device_scene.atlas.count == 1
    params = RenderParams(batch_spp=8, max_path_depth=2)
    r.render(FrameConfig(camera=FLOOR_CAM, params=params))
    img = r.readback_accumulation()
    assert np.isfinite(img).all()
    rb_diff = np.abs(img[..., 0] - img[..., 2])
    assert rb_diff.max() > 0.05

    jr = JaxRenderer()
    jr.initialize(32, 32)
    jr.set_scene(JaxScene.from_vkr_scene(
        _floor_scene(jproc, JaxTexture, jax_mip_chain)))
    jr.render(JaxFrameConfig(camera=FLOOR_CAM,
                             params=JaxRenderParams(batch_spp=8, max_path_depth=2)))
    assert r.last_frame_rays() == sum(int(x) for x in jr._last_rays)
    ref = np.asarray(jr.readback_accumulation())
    res = goldens.compare_ref(img[..., :3], ref[..., :3], "cornell_textured")
    assert res["ok"], res


def test_aniso_sampler_matches_manual_taps():
    """tests/test_textures.py:82-115 on the port."""
    atlas = tta.build_atlas([Texture(16, 16, 37,
                                     mips=build_mip_chain(_u8_checker()),
                                     srgb=False)])
    uv = torch.tensor([[0.4, 0.3]])
    tid = torch.tensor([0])
    duvdx = torch.tensor([[8.0 / 16.0, 0.0]])
    duvdy = torch.tensor([[0.0, 1.0 / 16.0]])
    taps = 4
    got = tta.sample_atlas_aniso(atlas, tid, uv, duvdx, duvdy, taps)[0].numpy()
    acc = np.zeros(4)
    for i in range(taps):
        s = (i + 0.5) / taps - 0.5
        p = tta.sample_atlas(atlas, tid, uv + torch.tensor([[8.0 / 16.0 * s, 0.0]]),
                             torch.zeros(1))
        acc += p[0].numpy()
    np.testing.assert_allclose(got, acc / taps, atol=1e-6)
    got = tta.sample_atlas_aniso(atlas, tid, uv, torch.tensor([[16.0, 0.0]]),
                                 torch.tensor([[0.0, 0.0]]), taps)[0].numpy()
    assert np.isfinite(got).all()


def test_aniso_render_valid_and_close_to_iso():
    """tests/test_textures.py:118-151 on the port, smaller (32x24, 2 spp):
    the anisotropic frame is finite, near the isotropic one in energy and
    not equal to it; and it matches the JAX renderer's anisotropic frame
    at ``goldens.compare_card``'s gate (measured: 0.65% of pixels over
    1e-3, relative L1 error 1.3e-5; one pixel is black in the reference's
    XLA-fused frame and 1.9e-6 in the port's, so no per-channel mean)."""
    cfg = FrameConfig(
        camera=OrientedCamera.look_at([0.0, 0.25, 2.9], [0.0, 0.05, -2.0], fovy=55),
        params=RenderParams(batch_spp=2, max_path_depth=2))
    scene = Scene.from_vkr_scene(_floor_scene(tproc, Texture, build_mip_chain))

    def render(taps):
        r = Renderer(device="cpu")
        r.options = r.options.replace(aniso_taps=taps)
        r.initialize(32, 24)
        r.set_scene(scene)
        r.render(cfg)
        assert r._integrator_config(cfg.params).aniso_taps == taps
        return r.readback_accumulation()[..., :3]

    iso, aniso = render(0), render(4)
    assert np.isfinite(aniso).all()
    np.testing.assert_allclose(aniso.mean(), iso.mean(), rtol=0.1)
    assert np.abs(aniso - iso).max() > 1e-4

    jr = JaxRenderer()
    jr.options = jr.options.replace(aniso_taps=4)
    jr.initialize(32, 24)
    jr.set_scene(JaxScene.from_vkr_scene(
        _floor_scene(jproc, JaxTexture, jax_mip_chain)))
    jr.render(JaxFrameConfig(camera=cfg.camera,
                             params=JaxRenderParams(batch_spp=2, max_path_depth=2)))
    ref = np.asarray(jr.readback_accumulation())[..., :3]
    res = goldens.compare_card(aniso, ref)
    assert res["ok"], res


@functools.lru_cache(maxsize=None)
def _textured_op_by_op():
    """cornell_textured's 4 samples per pixel through the port's CPU
    Renderer scene and through the JAX renderer's scene run op by op.
    Returns (port image, reference image, port rays, reference rays)."""
    name = "cornell_textured"
    scene, cam, params, _ = goldens.config(name)
    w = h = goldens.SIZE
    pr = Renderer(device="cpu")
    pr.initialize(w, h)
    pr.set_scene(scene)
    jsv = jproc.cornell_box()
    jsv.materials[0].tex_base_color = JaxTexture(
        16, 16, 37, mips=jax_mip_chain(goldens.checker()), srgb=False)
    jr = JaxRenderer()
    jr.initialize(w, h)
    jr.set_scene(JaxScene.from_vkr_scene(jsv))
    jparams = JaxRenderParams(max_path_depth=params.max_path_depth)
    jds, jcfg = jr.device_scene, jr._integrator_config(jparams)
    tds, tcfg = pr.device_scene, pr._integrator_config(params)
    assert jcfg.has_textures and jcfg.alpha_test
    assert tcfg.has_textures and tcfg.alpha_test
    px, py, valid, *_ = ti.swizzle_host(w, h)
    basis = cam.view_basis(w, h)
    jview = ji.ViewBuffers(*(jnp.asarray(a) for a in basis))
    tview = ti.ViewBuffers(*(torch.from_numpy(a) for a in basis))
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    dims = (float(w), float(h))
    port = ref = 0.0
    port_rays, ref_rays = [], []
    for s in range(goldens.SPP):
        with jax.disable_jit():
            fp = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(0),
                                jnp.uint32(0), bump_scale=jnp.float32(1.0),
                                pixel_radius=jnp.float32(1.0))
            jdims = jnp.array([w, h], jnp.float32)
            st = jps.make_state(0, jnp.uint32(s), jnp.uint32(0), jnp.asarray(px),
                                jnp.asarray(py), w, bufs=jds.rng)
            st, ro, rd = ji.camera_setup(jds, jcfg, fp, jview, jnp.asarray(px),
                                         jnp.asarray(py), jdims, st)
            rgb_j, _, rays_j = ji.trace_paths(
                jds, jcfg, fp, ro, rd, st, lane_mask=jnp.asarray(valid),
                footprint0=ji.camera_footprint0(jcfg, fp, jview, jdims, rd))
        tfp = ti.FrameParams()
        st = tps.make_state(0, s, 0, tpx, tpy, w)
        st, ro, rd = ti.camera_setup(tcfg, tview, tpx, tpy, dims, st)
        rgb_t, _, rays_t = ti.trace_paths(
            tds, tcfg, tfp, ro, rd, st, lane_mask=torch.from_numpy(valid),
            footprint0=ti.camera_footprint0(tcfg, tfp, tview, dims, rd))
        port_rays.append(rays_t.numpy()[valid])
        ref_rays.append(np.asarray(rays_j)[valid])
        port = port + np.stack([c.numpy() for c in rgb_t], -1)[valid] / goldens.SPP
        ref = ref + np.stack([np.asarray(c) for c in rgb_j], -1)[valid] / goldens.SPP

    def image(lanes):
        img = np.zeros((h, w, 3), np.float32)
        img[py[valid], px[valid]] = lanes
        return img

    return image(port), image(ref), port_rays, ref_rays


def test_cornell_textured_matches_jax_op_by_op():
    """Ray counts per lane exact; radiance at the textured golden's
    ``compare_ref`` gate (measured: 1.52% of pixels over 1e-3, mean
    relative error 4.0e-5)."""
    port, ref, port_rays, ref_rays = _textured_op_by_op()
    for rt, rj in zip(port_rays, ref_rays):
        np.testing.assert_array_equal(rt, rj)
    res = goldens.compare_ref(port, ref, "cornell_textured")
    assert res["ok"], res


def test_cornell_textured_golden():
    """The port's Renderer against tests/goldens/cornell_textured.pfm, and
    the reference run op by op within the same gate of its own golden
    (measured 1.22% of pixels over 1e-3)."""
    img, r = goldens.render("cornell_textured", "cpu")
    assert r._has_textures and r._has_alpha
    res = goldens.compare("cornell_textured", img)
    assert res["ok"], res
    _, ref, _, _ = _textured_op_by_op()
    res = goldens.compare("cornell_textured", ref)
    assert res["ok"], res
