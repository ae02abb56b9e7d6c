"""The merged two-queue modes of K1, K2 and K4 and the ``PT_WAVEFRONT``
variant on the CPU.

- The plain versions of the merged modes (``closest_and_occluded_resident``,
  ``_flat``, ``_streamed``: the plain closest walk on the first queue, the
  plain occluded walk on the second) against the reference's
  ``closest_and_occluded_pallas2`` / ``_pallas3`` / ``_streamed`` in Pallas
  interpret mode: triangles and flags exact, t within 1e-5 relative, u and
  v within 1e-4 absolute, as tests/test_torch_streamed.py holds K4: XLA
  contracts the barycentric dot products into FMAs, and where their terms
  cancel one rounding moves u or v by more than 1e-5 (measured: 1.55e-5
  on 1 lane of 984 on K1's and K2's queues); with and without the
  per-half coherence sort, on
  queues of lengths that are not whole blocks, with dead lanes. Against
  the port's own separate closest and occluded calls: bitwise.
- ``PT_WAVEFRONT`` against ``PT_MEGAKERNEL`` on the port, as
  tests/test_render.py:150-184 holds the reference (cornell, 32x32, 2 spp,
  depth 4): every channel within 1e-6 relative, alpha exact; on the K1
  route it goes through the merged mode (one merged call per bounce that
  has a deferred queue, no separate occluded call). The same on the
  flat-cull route (``RPTR_COMPACT_LANES=0``), the streamed route and the
  two-level route, which dispatch the two queues separately.
- The textured wavefront regression of tests/test_render.py:188-218: the
  carry holds the deferred queue and the footprint, and the frame is
  finite and lit.
- The golden ``cornell_wavefront`` against tests/goldens/cornell_wavefront.pfm
  (``goldens.compare``) and against the JAX package's wavefront run op by
  op (ray counts per lane exact, ``goldens.compare_ref``).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend.renderer import (
    Renderer as JaxRenderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.ops import bvh as jbvh
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas2 as tp2
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas3 as tp3
from realtimepathtracingresearchframework_tpu.ops import traverse_stream as jts
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    VARIANT_MEGAKERNEL,
    VARIANT_WAVEFRONT,
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.models.texture import (
    Texture,
    build_mip_chain,
)
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident as tr
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_stream as ts
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_traverse_kernels import _rays, _terrain  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

N_C, N_S = 1000, 700  # queue lengths: not whole blocks


@functools.lru_cache(maxsize=None)
def _bvh(leaf_size):
    return jbvh.build_threaded_bvh(*_terrain(24), leaf_size=leaf_size)


def _queues(seed):
    """A closest queue (coherent and incoherent rays, 20% dead) and a
    shadow queue (segments just short of / past each closest hit of other
    rays, and open ones), numpy: (ro, rd, tmin, tmax) each."""
    rng = np.random.default_rng(seed)
    ro_a, rd_a = _rays(N_C // 2, rng, "coherent")
    ro_b, rd_b = _rays(N_C - N_C // 2, rng, "incoherent")
    ro_c = np.concatenate([ro_a, ro_b]).astype(np.float32)
    rd_c = np.concatenate([rd_a, rd_b]).astype(np.float32)
    n_c = len(ro_c)
    assert n_c % 128
    tmax_c = np.where(rng.uniform(size=n_c) < 0.2, 0.0, 2.0e32).astype(np.float32)
    ro_s, rd_s = _rays(N_S, rng, "incoherent")
    n_s = len(ro_s)
    tmax_s = rng.choice(np.array([0.0, 0.5, 2.0, 30.0], np.float32), n_s)
    tmin_s = np.full(n_s, 1e-4, np.float32)
    return ((ro_c, rd_c, np.zeros(n_c, np.float32), tmax_c),
            (ro_s.astype(np.float32), rd_s.astype(np.float32), tmin_s,
             tmax_s.astype(np.float32)))


def _torch_q(q):
    ro, rd, tmin, tmax = q
    comps = tuple(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for a in (ro, rd) for k in range(3))
    return comps, torch.from_numpy(tmin), torch.from_numpy(tmax)


def _jax_q(q):
    ro, rd, tmin, tmax = q
    comps = tuple(jnp.asarray(np.ascontiguousarray(a[:, k]))
                  for a in (ro, rd) for k in range(3))
    return comps, jnp.asarray(tmin), jnp.asarray(tmax)


def _assert_close(hit, blocked, ref_hit, ref_blocked):
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref_hit.tri))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref_hit.t), rtol=1e-5, atol=0)
    for p, r in ((hit.u, ref_hit.u), (hit.v, ref_hit.v)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(ref_blocked))


def _assert_bitwise(hit, blocked, sep_hit, sep_blocked):
    for a, b in zip(hit, sep_hit):
        assert torch.equal(a, b)
    assert torch.equal(blocked, sep_blocked)


def _hit_share(hit, blocked):
    """Both queues exercise both outcomes."""
    h = (hit.tri >= 0).float().mean()
    assert 0.05 < h < 0.95 and blocked.any() and not blocked.all()


@pytest.mark.parametrize("compact", [False, True])
def test_k1_merged_plain_matches_reference(compact):
    tb = _bvh(32)
    bb, rb = tp2.pack_for_pallas2(tb), tr.pack_resident(tb)
    qc, qs = _queues(1)
    (cc, tnc, txc), (cs, tns, txs) = _torch_q(qc), _torch_q(qs)
    hit, blocked = tr.closest_and_occluded_resident(
        rb, cc, tnc, txc, cs, tns, txs, compact=compact)
    _hit_share(hit, blocked)
    tp2.INTERPRET = True
    try:
        ref_hit, ref_blocked = tp2.closest_and_occluded_pallas2(
            bb, *_jax_q(qc), *_jax_q(qs), compact=compact)
    finally:
        tp2.INTERPRET = False
    _assert_close(traverse.map_rows_to_tris(rb, hit), blocked, ref_hit, ref_blocked)
    sep = tr.closest_hit_resident(rb, Vec3(*cc[:3]), Vec3(*cc[3:]), tnc, txc,
                                  compact=compact)
    sep_b = tr.occluded_resident(rb, Vec3(*cs[:3]), Vec3(*cs[3:]), tns, txs,
                                 compact=compact)
    _assert_bitwise(hit, blocked, sep, sep_b)


@pytest.mark.parametrize("compact", [False, True])
def test_k2_merged_plain_matches_reference(compact):
    tb = _bvh(128)
    bb3, fb = tp3.pack_for_pallas3(tb), tf.pack_flat(tb)
    qc, qs = _queues(2)
    (cc, tnc, txc), (cs, tns, txs) = _torch_q(qc), _torch_q(qs)
    hit, blocked = tf.closest_and_occluded_flat(
        fb, cc, tnc, txc, cs, tns, txs, block=512, groups=4, compact=compact)
    _hit_share(hit, blocked)
    tp2.INTERPRET = tp3.INTERPRET = True
    try:
        ref_hit, ref_blocked = tp3.closest_and_occluded_pallas3(
            bb3, *_jax_q(qc), *_jax_q(qs), block=512, compact=compact, groups=4)
    finally:
        tp2.INTERPRET = tp3.INTERPRET = False
    _assert_close(traverse.map_rows_to_tris(fb, hit), blocked, ref_hit, ref_blocked)
    sep = tf.closest_hit_flat(fb, Vec3(*cc[:3]), Vec3(*cc[3:]), tnc, txc,
                              block=512, compact=compact)
    sep_b = tf.occluded_flat(fb, Vec3(*cs[:3]), Vec3(*cs[3:]), tns, txs,
                             block=512, compact=compact)
    _assert_bitwise(hit, blocked, sep, sep_b)


@functools.lru_cache(maxsize=None)
def _streamed():
    f = Scene.from_vkr_scene(procedural.terrain(grid=48)).flatten_world()
    return jts.pack_streamed(f.v0, f.e1, f.e2), ts.pack_streamed(f.v0, f.e1, f.e2)


def _stream_queues():
    """The streamed fixture's scale (terrain(48), extent 20): a camera fan
    and incoherent rays, and a shadow queue toward the sun."""
    rng = np.random.default_rng(3)
    side = 24
    u = np.linspace(-1.0, 1.0, side, dtype=np.float32)
    uu, vv = np.meshgrid(u, u)
    d = np.stack([uu.ravel(), -0.4 + 0.3 * vv.ravel(), -np.ones(side * side)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ro_f = np.broadcast_to(np.array([0.0, 5.0, 12.0], np.float32), d.shape)
    ro_i = rng.uniform(-10, 10, (N_C - len(d), 3)).astype(np.float32)
    ro_i[:, 1] = rng.uniform(0.5, 3.0, len(ro_i))
    rd_i = rng.normal(size=ro_i.shape).astype(np.float32)
    rd_i /= np.linalg.norm(rd_i, axis=-1, keepdims=True)
    ro_c = np.concatenate([ro_f, ro_i]).astype(np.float32)
    rd_c = np.concatenate([d, rd_i]).astype(np.float32)
    tmax_c = np.where(rng.uniform(size=N_C) < 0.1, 0.0, 2.0e32).astype(np.float32)
    ro_s = rng.uniform(-10, 10, (N_S, 3)).astype(np.float32)
    ro_s[:, 1] = rng.uniform(-0.5, 1.5, N_S)
    sun = np.array([0.4, 0.7, 0.2], np.float32)
    rd_s = np.broadcast_to(sun / np.linalg.norm(sun), ro_s.shape).astype(np.float32)
    tmax_s = np.where(rng.uniform(size=N_S) < 0.1, 0.0, 2.0e16).astype(np.float32)
    return ((ro_c, rd_c, np.zeros(N_C, np.float32), tmax_c),
            (ro_s, rd_s, np.full(N_S, 1e-3, np.float32), tmax_s))


@pytest.mark.parametrize("sort", [False, True])
def test_k4_merged_plain_matches_reference(sort):
    jb, pb = _streamed()
    qc, qs = _stream_queues()
    (cc, tnc, txc), (cs, tns, txs) = _torch_q(qc), _torch_q(qs)
    hit, blocked = ts.closest_and_occluded_streamed(
        pb, cc, tnc, txc, cs, tns, txs, sort=sort)
    _hit_share(hit, blocked)
    jts.INTERPRET = tp2.INTERPRET = True
    try:
        ref_hit, ref_blocked = jts.closest_and_occluded_streamed(
            jb, *_jax_q(qc), *_jax_q(qs), sort=sort)
    finally:
        jts.INTERPRET = tp2.INTERPRET = False
    _assert_close(hit, blocked, ref_hit, ref_blocked)
    sep = ts.closest_hit_streamed(pb, Vec3(*cc[:3]), Vec3(*cc[3:]), tnc, txc,
                                  sort=sort)
    sep_b = ts.occluded_streamed(pb, Vec3(*cs[:3]), Vec3(*cs[3:]), tns, txs,
                                 sort=sort)
    _assert_bitwise(hit, blocked, sep, sep_b)


# ---------------------------------------------------------------------------
# The PT_WAVEFRONT variant
# ---------------------------------------------------------------------------

CAM = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
ROUTES = {
    "k1": {},
    "flat": {"RPTR_TRAVERSAL_V3": "1", "RPTR_COMPACT_LANES": "0"},
    "streamed": {"RPTR_FORCE_STREAMED_TRAVERSAL": "1"},
    "two_level": {},
}


def _render(variant, route, monkeypatch, size=32, spp=2, depth=4):
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    r = Renderer(device="cpu")
    r.options = r.options.replace(use_tlas=route == "two_level")
    r.initialize(size, size)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    assert r.set_variant(variant)
    r.render(FrameConfig(camera=CAM, params=RenderParams(batch_spp=spp,
                                                         max_path_depth=depth)))
    return r, r.readback_accumulation()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_wavefront_matches_megakernel(route, monkeypatch):
    """tests/test_render.py:150-184 on the port, on each route."""
    calls = {"merged": 0, "occluded": 0}
    merged, occluded = tr.merged_plain, traverse.occluded_threaded

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tr, "merged_plain", count("merged", merged))
    r, mega = _render(VARIANT_MEGAKERNEL, route, monkeypatch)
    mega_rays = r.last_frame_rays()
    calls.update(merged=0, occluded=0)
    monkeypatch.setattr(traverse, "occluded_threaded", count("occluded", occluded))
    r, wave = _render(VARIANT_WAVEFRONT, route, monkeypatch)
    assert r.active_variant == VARIANT_WAVEFRONT and r._wavefront is None
    assert r._integrator_config(RenderParams()).wavefront
    assert r.last_frame_rays() == mega_rays
    res = goldens.compare_ref(wave[..., :3], mega[..., :3])
    assert res["max_rel"] <= 1e-6, res
    np.testing.assert_array_equal(mega[..., 3], wave[..., 3])
    if route == "k1":
        # every bounce after the first resolves its deferred queue in the
        # merged call (2 samples x 4 chunks-worth of 3 later bounces at
        # most), and only the merged plain version walks shadow rays
        assert calls["merged"] > 0
        assert calls["occluded"] == calls["merged"]
    else:
        assert calls["merged"] == 0


def test_unported_variants_raise():
    """Every registered variant but RQ_CLOSEST is selectable, as in the
    reference (renderer.py:306-321); RQ_CLOSEST and an unknown name fall
    back to the megakernel and return False. tests/test_torch_variants.py
    renders each one."""
    r = Renderer(device="cpu")
    assert VARIANT_WAVEFRONT in r.variants() and VARIANT_MEGAKERNEL in r.variants()
    for name in r.variants():
        assert r.set_variant(name) == (name != "RQ_CLOSEST")
        assert r.active_variant == (VARIANT_MEGAKERNEL if name == "RQ_CLOSEST"
                                    else name)
    assert not r.set_variant("NO_SUCH_VARIANT")
    assert r.active_variant == VARIANT_MEGAKERNEL


def test_wavefront_renders_textured_scene():
    """tests/test_render.py:188-218 on the port: the carry holds both the
    deferred queue and the footprint."""
    sv = procedural.cornell_box()
    tex = np.zeros((8, 8, 4), np.float32)
    tex[..., 0] = 0.8
    tex[..., 3] = 1.0
    sv.materials[0].tex_base_color = Texture(8, 8, 37, mips=build_mip_chain(tex),
                                             srgb=False)
    r = Renderer(device="cpu")
    r.initialize(24, 24)
    r.set_scene(Scene.from_vkr_scene(sv))
    assert r._has_textures
    r.set_variant(VARIANT_WAVEFRONT)
    r.render(FrameConfig(camera=CAM, params=RenderParams(max_path_depth=3)))
    img = r.readback_accumulation()
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0.01


def test_cornell_wavefront_golden():
    img, r = goldens.render("cornell_wavefront", "cpu")
    assert r.active_variant == VARIANT_WAVEFRONT
    res = goldens.compare("cornell_wavefront", img)
    assert res["ok"], res


def test_cornell_wavefront_matches_jax_op_by_op():
    """The golden's 4 samples per pixel through the JAX package's wavefront
    run op by op and the port's, on each package's own cornell scene: ray
    counts per lane exact, radiance at ``goldens.compare_ref``'s gate."""
    name = "cornell_wavefront"
    scene, cam, params, _ = goldens.config(name)
    w = h = goldens.SIZE
    pr = Renderer(device="cpu")
    pr.initialize(w, h)
    pr.set_scene(scene)
    pr.set_variant(VARIANT_WAVEFRONT)
    tds, tcfg = pr.device_scene, pr._integrator_config(params)
    jr = JaxRenderer()
    jr.initialize(w, h)
    jr.set_scene(JaxScene.from_vkr_scene(jproc.cornell_box()))
    jds = jr.device_scene
    jcfg = jr._integrator_config(params)._replace(wavefront=True)
    assert tcfg.wavefront
    px, py, valid, *_ = ti.swizzle_host(w, h)
    basis = cam.view_basis(w, h)
    jview = ji.ViewBuffers(*(jnp.asarray(a) for a in basis))
    tview = ti.ViewBuffers(*(torch.from_numpy(a) for a in basis))
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    port = ref = 0.0
    for s in range(goldens.SPP):
        with jax.disable_jit():
            fp = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(0),
                                jnp.uint32(0))
            st = jps.make_state(0, jnp.uint32(s), jnp.uint32(0), jnp.asarray(px),
                                jnp.asarray(py), w, bufs=jds.rng)
            st, ro, rd = ji.camera_setup(jds, jcfg, fp, jview, jnp.asarray(px),
                                         jnp.asarray(py),
                                         jnp.array([w, h], jnp.float32), st)
            rgb_j, _, rays_j = ji.trace_paths(jds, jcfg, fp, ro, rd, st,
                                              lane_mask=jnp.asarray(valid))
        st = tps.make_state(0, s, 0, tpx, tpy, w)
        st, ro, rd = ti.camera_setup(tcfg, tview, tpx, tpy, (float(w), float(h)), st)
        rgb_t, _, rays_t = ti.trace_paths(tds, tcfg, ti.FrameParams(), ro, rd, st,
                                          lane_mask=torch.from_numpy(valid))
        np.testing.assert_array_equal(rays_t.numpy()[valid], np.asarray(rays_j)[valid])
        port = port + np.stack([c.numpy() for c in rgb_t], -1)[valid] / goldens.SPP
        ref = ref + np.stack([np.asarray(c) for c in rgb_j], -1)[valid] / goldens.SPP

    def image(lanes):
        img = np.zeros((h, w, 3), np.float32)
        img[py[valid], px[valid]] = lanes
        return img

    res = goldens.compare_ref(image(port), image(ref))
    assert res["ok"], res
