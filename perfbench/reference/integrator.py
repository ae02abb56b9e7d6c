"""The reference path integrator: one 1-spp path per lane, in plain PyTorch.

A frozen copy of the port's monolithic pass (``ops/integrator.py``:
``_make_bounce_fns``, ``trace_paths``, ``camera_setup``, ``blend_sample``)
restricted to what the benchmark's cells render: the uniform (LCG) RNG,
the pinhole camera, one-level scenes, isotropic mip texturing (no alpha
test, no thin transmission: ``render.py`` refuses scenes that need them),
uniform or binned-RIS light selection, sun and sky. The closest-hit
and occlusion queries go to ``walk.py``, the reference's own BVH, in place
of the port's kernels. Every lane is independent, so any set of pixels and
sample indices can be traced together and equal the same lanes of a full
frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from perfbench.reference import nee as nee_mod
from perfbench.reference import rng as lcg
from perfbench.reference import vec3 as v3
from perfbench.reference.bsdf_gltf import (
    GLTFMaterial,
    gltf_bsdf_v,
    gltf_wpdf_v,
    sample_gltf_brdf_v,
)
from perfbench.reference.intersect import T_MAX
from perfbench.reference.material import (
    BASE_MATERIAL_ONESIDED,
)
from perfbench.reference.sky import SkyParams, sky_radiance_v
from perfbench.reference.texture_atlas import TextureAtlas, sample_atlas
from perfbench.reference.vec3 import Vec3
from perfbench.reference.walk import Walk

RAY_EPSILON = 5.0e-6  # vulkan/gpu_params.glsl:28

# per-triangle and per-material tables, stored transposed as (W, T) f32;
# integer columns are float values
ATTR_W = 32
_A_E1, _A_E2 = 0, 3
_A_N0, _A_N1, _A_N2 = 6, 9, 12
_A_UV0, _A_UV1, _A_UV2 = 15, 17, 19
_A_TAN = 21  # 4 wide (xyz + handedness)
_A_DENS = 25
_A_MID = 26  # material id as float value

MAT_W = 16
_M_BASE = 0  # 3 wide
_M_ROUGH, _M_SPEC, _M_METAL, _M_IOR = 3, 4, 5, 6
_M_STRANS, _M_EMIT = 7, 8
_M_FLAGS, _M_BCTEX, _M_SPTEX, _M_NMTEX = 9, 10, 11, 12


class Scene(NamedTuple):
    """Everything the integrator reads, on one device."""

    walk: Walk
    attr_packed: torch.Tensor  # (ATTR_W, T) f32 per source triangle
    mat_packed: torch.Tensor  # (MAT_W, M) f32
    lights: nee_mod.TriLightBuffers
    sky: SkyParams
    atlas: TextureAtlas


class Config(NamedTuple):
    max_path_depth: int = 9
    light_bin_size: int = 16
    use_light_bins: bool = False
    num_lights: int = 0
    has_textures: bool = False


class FrameParams(NamedTuple):
    rr_path_depth: int = 2
    pixel_radius: float = 1.0
    bump_scale: float = 1.0


class View(NamedTuple):
    """(3,) f32 camera basis (ViewParams)."""

    cam_pos: torch.Tensor
    cam_du: torch.Tensor
    cam_dv: torch.Tensor
    cam_dir_top_left: torch.Tensor


def pack_attr_table(flat) -> torch.Tensor:
    """Per-triangle shading attributes -> (ATTR_W, T) f32 column table."""
    cols = [
        flat.e1, flat.e2, flat.n0, flat.n1, flat.n2,
        flat.uv0, flat.uv1, flat.uv2, flat.tangent,
        np.asarray(flat.texel_density)[:, None],
        np.asarray(flat.material_id, np.float32)[:, None],
    ]
    packed = np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)
    packed = np.pad(packed, ((0, 0), (0, ATTR_W - packed.shape[1])))
    return torch.from_numpy(np.ascontiguousarray(packed.T))


def pack_material_table(mats) -> torch.Tensor:
    """MaterialTable (numpy) -> (MAT_W, M) f32 column table."""

    def as_f32(a):
        return np.asarray(a, np.float32)[:, None]

    cols = [
        np.asarray(mats.base_color, np.float32),
        as_f32(mats.roughness), as_f32(mats.specular), as_f32(mats.metallic),
        as_f32(mats.ior), as_f32(mats.specular_transmission),
        as_f32(mats.emission_intensity), as_f32(mats.flags),
        as_f32(mats.base_color_tex), as_f32(mats.specular_tex),
        as_f32(mats.normal_tex),
    ]
    packed = np.concatenate(cols, axis=1)
    packed = np.pad(packed, ((0, 0), (0, MAT_W - packed.shape[1])))
    return torch.from_numpy(np.ascontiguousarray(packed.T))


def _fetch_cols_ranges(tbl_t, idx, ranges):
    """The table rows in ``ranges`` at per-lane index ``idx``."""
    rows = [r for a, b in ranges for r in range(a, b)]
    sub = torch.cat([tbl_t[a:b] for a, b in ranges], dim=0)
    cols = sub.index_select(1, idx)
    return {r: cols[i] for i, r in enumerate(rows)}


def _material_from_cols(c) -> GLTFMaterial:
    """Fetched material columns -> SoA GLTFMaterial (gltf_bsdf.glsl:47-56)."""
    base = Vec3(c[_M_BASE], c[_M_BASE + 1], c[_M_BASE + 2])
    flags = c[_M_FLAGS].to(torch.int32)
    return GLTFMaterial(
        base_color=base, metallic=c[_M_METAL], specular=c[_M_SPEC],
        roughness=c[_M_ROUGH], ior=c[_M_IOR],
        specular_transmission=c[_M_STRANS], transmission_color=base,
        onesided=(flags & BASE_MATERIAL_ONESIDED) != 0,
    )


def _ocean(y):
    """0.7*(1-|y|)^5 below the horizon (pt_megakernel.glsl:118-122)."""
    a = torch.clamp(1.0 - y.abs(), min=0.0)
    a2 = a * a
    return torch.where(y <= 0.0, 0.7 * (a * (a2 * a2)), 1.0)


def _sky_illum(sc: Scene, rd: Vec3, prev_pdf) -> Vec3:
    """compute_sky_illum (pt_megakernel.glsl:113-149)."""
    zero = v3.splat(torch.zeros_like(rd.x))
    atm = v3.vabs(sky_radiance_v(sc.sky, rd))
    ocean = _ocean(rd.y)
    dm = v3.normalize(Vec3(rd.x, rd.y.abs(), rd.z))
    sd = sc.sky.sun_dir
    in_cap = (dm.x * sd[0] + dm.y * sd[1] + dm.z * sd[2]) >= sc.sky.sun_cos_angle
    sr = sc.sky.sun_radiance
    sun = v3.where(in_cap, Vec3(sr[0] * ocean, sr[1] * ocean, sr[2] * ocean),
                   zero)
    light_pdf = sr[3] * nee_mod.sun_dir_pdf(sc.sky.sun_cos_angle)
    w = nee_mod.nee_mis_heuristic(1.0, prev_pdf, 1.0, light_pdf)
    return atm + v3.vabs(sun) * w


class NEECandidate(NamedTuple):
    contrib: Vec3
    dir: Vec3
    eps: torch.Tensor
    shadow_tmax: torch.Tensor
    traced: torch.Tensor
    uncond: torch.Tensor


def _nee_candidate(sc: Scene, cfg: Config, hit_p: Vec3, hit_n: Vec3,
                   hit_gn: Vec3, mat: GLTFMaterial, w_o: Vec3, dir_sample,
                   sel_sample, total_t) -> NEECandidate:
    """sample_direct_light minus the visibility trace (mc/nee.glsl:32-90)."""
    sky = sc.sky
    sun_w = sky.sun_radiance[3]
    sun_sel = sel_sample[0] <= sun_w
    sun_dir = nee_mod.sample_sun_dir_v(sky.sun_dir, sky.sun_cos_angle,
                                       dir_sample[0], dir_sample[1])
    sun_pdf = nee_mod.sun_dir_pdf(sky.sun_cos_angle)
    sr = sky.sun_radiance
    sun_scale = 1.0 / (torch.clamp(sun_w, min=1e-9) * sun_pdf)
    sun_illum = Vec3(sr[0] * sun_scale, sr[1] * sun_scale, sr[2] * sun_scale)
    sun_light_pdf = sun_pdf * sun_w

    if cfg.num_lights > 0:
        sel2 = (
            torch.clamp((sel_sample[0] - sun_w)
                        / torch.clamp(1.0 - sun_w, min=1e-9), 0.0, 1.0),
            sel_sample[1],
        )
        ls = nee_mod.sample_tri_lights_v(
            sc.lights, hit_p, hit_n, dir_sample, sel2,
            cfg.light_bin_size, cfg.use_light_bins,
        )
        inv_area_w = 1.0 / torch.clamp(1.0 - sun_w, min=1e-9)
        tri_illum = ls.illum * inv_area_w
        tri_light_pdf = ls.pdf * (1.0 - sun_w)
        tri_mis_pdf = ls.mis_wpdf * (1.0 - sun_w)
        illum = v3.where(sun_sel, sun_illum, tri_illum)
        light_dir = v3.where(sun_sel, sun_dir, ls.dir)
        light_dist = torch.where(sun_sel, 2.0e16, ls.dist)
        light_pdf = torch.where(sun_sel, sun_light_pdf, tri_light_pdf)
        mis_pdf = torch.where(sun_sel, sun_light_pdf, tri_mis_pdf)
    else:
        zero = torch.zeros_like(hit_p.x)
        illum = sun_illum + v3.splat(zero)
        light_dir = sun_dir
        light_dist = zero + 2.0e16
        light_pdf = zero + sun_light_pdf
        mis_pdf = light_pdf

    strict = v3.dot(light_dir, hit_gn) * v3.dot(light_dir, hit_n) > 0.0
    candidate = (light_pdf > 0.0) & strict
    eps = (v3.length(hit_p) + total_t) * RAY_EPSILON
    seg_ok = light_dist - 2.0 * eps > 0.0
    shadow_tmax = torch.maximum(light_dist - eps, eps)
    shadow_tmax_eff = torch.where(candidate & seg_ok, shadow_tmax, eps)

    bsdf_pdf = gltf_wpdf_v(mat, hit_n, w_o, light_dir)
    f = gltf_bsdf_v(mat, hit_n, w_o, light_dir)
    w = nee_mod.nee_mis_heuristic(1.0, mis_pdf, 1.0, bsdf_pdf)
    contrib = illum * f * (w * v3.dot(light_dir, hit_n).abs())
    # a non-finite contribution (a sample from a point in an emitter's
    # plane) is dropped, as the program drops it
    finite = (torch.isfinite(contrib.x) & torch.isfinite(contrib.y)
              & torch.isfinite(contrib.z))
    base_ok = candidate & (bsdf_pdf >= 0.0) & finite
    zero3 = v3.splat(torch.zeros_like(w))
    return NEECandidate(
        contrib=v3.where(base_ok, contrib, zero3), dir=light_dir, eps=eps,
        shadow_tmax=shadow_tmax_eff, traced=base_ok & seg_ok,
        uncond=base_ok & ~seg_ok,
    )


class Carry(NamedTuple):
    """Per-lane path state between bounces."""

    ro: Vec3
    rd: Vec3
    t_min: torch.Tensor
    illum: Vec3
    throughput: Vec3
    active: torch.Tensor
    prev_pdf: torch.Tensor
    bounce_count: torch.Tensor
    total_t: torch.Tensor
    rng_state: torch.Tensor  # int64 holding the LCG's u32 state
    closest_rays: torch.Tensor
    shadow_rays: torch.Tensor
    foot: Optional[tuple] = None  # (F00, F11, F01) texture footprint


def _footprint_to_dpdxy_v(rd: Vec3, fa, fb, fc):
    """footprint_to_dpdxy (footprint.glsl:44-61)."""
    B = fa + fb
    C = fa * fb - fc * fc
    D = torch.sqrt(torch.clamp(B * B * 0.25 - C, min=0.0))
    ev0 = 0.5 * B - D
    ev1 = 0.5 * B + D
    use = fc.abs() > 3.0e-39
    x0x = torch.where(use, fc, 1.0)
    x0y = torch.where(use, ev0 - fa, 0.0)
    x1x = torch.where(use, ev1 - fb, 0.0)
    x1y = torch.where(use, fc, 1.0)
    inv0 = 1.0 / torch.clamp(torch.sqrt(x0x * x0x + x0y * x0y), min=1e-30)
    inv1 = 1.0 / torch.clamp(torch.sqrt(x1x * x1x + x1y * x1y), min=1e-30)
    s0 = torch.sqrt(torch.clamp(ev0, min=0.0)) * inv0
    s1 = torch.sqrt(torch.clamp(ev1, min=0.0)) * inv1
    t, b = nee_mod.ortho_frame_v(rd)
    dpdx = Vec3((t.x * x0x + b.x * x0y) * s0, (t.y * x0x + b.y * x0y) * s0,
                (t.z * x0x + b.z * x0y) * s0)
    dpdy = Vec3((t.x * x1x + b.x * x1y) * s1, (t.y * x1x + b.y * x1y) * s1,
                (t.z * x1x + b.z * x1y) * s1)
    return dpdx, dpdy


def _dpdxy_to_footprint_v(rd: Vec3, dpdx: Vec3, dpdy: Vec3):
    """dpdxy_to_footprint (footprint.glsl:10-15)."""
    t, b = nee_mod.ortho_frame_v(rd)
    tx, ty = v3.dot(t, dpdx), v3.dot(t, dpdy)
    bx, by = v3.dot(b, dpdx), v3.dot(b, dpdy)
    return (tx * tx + ty * ty, bx * bx + by * by, tx * bx + ty * by)


def _reflect_footprint_v(w_i: Vec3, rd: Vec3, fa, fb, fc):
    """reflect_footprint (footprint.glsl:37-42)."""
    n = v3.normalize(w_i - rd)
    ts, bs = nee_mod.ortho_frame_v(rd)
    rt = ts - n * (2.0 * v3.dot(n, ts))
    rb = bs - n * (2.0 * v3.dot(n, bs))
    td, bd = nee_mod.ortho_frame_v(w_i)
    t00, t01 = v3.dot(td, rt), v3.dot(td, rb)
    t10, t11 = v3.dot(bd, rt), v3.dot(bd, rb)
    m00 = t00 * fa + t01 * fc
    m01 = t00 * fc + t01 * fb
    m10 = t10 * fa + t11 * fc
    m11 = t10 * fc + t11 * fb
    return (m00 * t00 + m01 * t01, m10 * t10 + m11 * t11,
            m00 * t10 + m01 * t11)


def _draw2(state):
    state, x = lcg.lcg_float(state)
    state, y = lcg.lcg_float(state)
    return state, (x, y)


def _visit_hit(sc: Scene, cfg: Config, fp: FrameParams, carry: Carry):
    """Traverse + hit attributes + textures + emitter MIS. Returns (carry
    with the miss handled, the hit's shading context)."""
    num_bins = max(cfg.num_lights // max(cfg.light_bin_size, 1), 1)
    ro, rd, active = carry.ro, carry.rd, carry.active
    closest_rays = carry.closest_rays + active.to(torch.int32)
    tmax_eff = torch.where(active, T_MAX, 0.0)
    hit_t, hit_tri, hit_u, hit_v = sc.walk.closest(ro, rd, carry.t_min,
                                                   tmax_eff)
    illum = carry.illum
    was_miss = hit_tri < 0

    sky = _sky_illum(sc, rd, carry.prev_pdf)
    illum = v3.where(active & was_miss, illum + carry.throughput * sky, illum)
    active = active & ~was_miss

    tri = torch.clamp(hit_tri, min=0).to(torch.int64)
    attr_ranges = ([(_A_E1, _A_MID + 1)] if cfg.has_textures
                   else [(_A_E1, _A_UV0), (_A_MID, _A_MID + 1)])
    c = _fetch_cols_ranges(sc.attr_packed, tri, attr_ranges)
    e1 = Vec3(c[_A_E1], c[_A_E1 + 1], c[_A_E1 + 2])
    e2 = Vec3(c[_A_E2], c[_A_E2 + 1], c[_A_E2 + 2])
    b1, b2 = hit_u, hit_v
    b0 = 1.0 - b1 - b2
    n_sh = Vec3(
        c[_A_N0] * b0 + c[_A_N1] * b1 + c[_A_N2] * b2,
        c[_A_N0 + 1] * b0 + c[_A_N1 + 1] * b1 + c[_A_N2 + 1] * b2,
        c[_A_N0 + 2] * b0 + c[_A_N1 + 2] * b1 + c[_A_N2 + 2] * b2,
    )
    gn_raw = v3.cross(e1, e2)
    gn_raw = v3.where(v3.dot(n_sh, gn_raw) < 0.0, -gn_raw, gn_raw)
    gn_len = v3.length(gn_raw)
    gn = gn_raw * (1.0 / torch.clamp(gn_len, min=1e-20))
    approx_sa = ((0.5 * gn_len) * v3.dot(gn, rd).abs()
                 / torch.clamp(hit_t * hit_t, min=1e-20))
    n_sh = v3.normalize(n_sh)

    mid = c[_A_MID].to(torch.int64)
    mat_ranges = ([(_M_BASE, _M_NMTEX + 1)] if cfg.has_textures
                  else [(_M_BASE, _M_BCTEX)])
    mc = _fetch_cols_ranges(sc.mat_packed, mid, mat_ranges)
    mat = _material_from_cols(mc)

    p = ro + rd * hit_t
    w_o = -rd
    backface = v3.dot(w_o, gn) < 0.0
    flip = backface & ~mat.onesided
    n_sh = v3.where(flip, -n_sh, n_sh)
    gn = v3.where(flip, -gn, gn)
    total_t = torch.where(active, carry.total_t + hit_t, carry.total_t)

    if cfg.has_textures:
        mat, n_sh = _shade_textures(sc, fp, carry, c, mc, mat, n_sh, gn, rd,
                                    total_t, b0, b1, b2)

    emit_intensity = mc[_M_EMIT]
    emit_radiance = mat.base_color * emit_intensity
    has_emit = emit_intensity > 0.0
    wpdf_light = (1.0 - sc.sky.sun_radiance[3]) * nee_mod.approx_tri_lights_pdf(
        approx_sa, max(cfg.num_lights, 1), num_bins, cfg.use_light_bins)
    w_emit = nee_mod.nee_mis_heuristic(1.0, carry.prev_pdf, 1.0, wpdf_light)
    illum = v3.where(active & has_emit,
                     illum + carry.throughput * emit_radiance * w_emit, illum)
    bounce_count = torch.where(active, carry.bounce_count + 1,
                               carry.bounce_count)
    carry = carry._replace(illum=illum, active=active, bounce_count=bounce_count,
                           total_t=total_t, closest_rays=closest_rays)
    return carry, (p, n_sh, gn, mat, w_o)


def _shade_textures(sc: Scene, fp: FrameParams, carry: Carry, c, mc,
                    mat: GLTFMaterial, n_sh: Vec3, gn: Vec3, rd: Vec3, total_t,
                    b0, b1, b2):
    """Base colour, specular/roughness and normal map at the mip of the
    transported footprint (rt/material_textures.glsl)."""
    uv = torch.stack([
        c[_A_UV0] * b0 + c[_A_UV1] * b1 + c[_A_UV2] * b2,
        c[_A_UV0 + 1] * b0 + c[_A_UV1 + 1] * b1 + c[_A_UV2 + 1] * b2,
    ], dim=-1)
    density = c[_A_DENS]
    dpdx, dpdy = _footprint_to_dpdxy_v(rd, *carry.foot)
    dt_un = rd - gn * v3.dot(rd, gn)
    cos2 = torch.clamp(1.0 - v3.dot(dt_un, dt_un), min=0.0)
    elong_s = 1.0 / torch.clamp(torch.sqrt(cos2) + cos2, min=1e-6)
    ex = dt_un * elong_s
    dpdx_e = dpdx + ex * v3.dot(dpdx, dt_un)
    dpdy_e = dpdy + ex * v3.dot(dpdy, dt_un)
    footprint_world = (
        torch.maximum(v3.length(dpdx_e), v3.length(dpdy_e)) * total_t)

    def tex_sample(tid):
        base_w = sc.atlas.desc[torch.clamp(tid, min=0).to(torch.int64),
                               0, 1].to(torch.float32)
        mip = torch.log2(torch.clamp(footprint_world * density * base_w,
                                     min=1.0))
        return sample_atlas(sc.atlas, tid, uv, mip)

    bc_tid = mc[_M_BCTEX].to(torch.int32)
    bc = tex_sample(bc_tid)
    base = v3.where(bc_tid >= 0, Vec3(bc[:, 0], bc[:, 1], bc[:, 2]),
                    mat.base_color)
    mat = mat._replace(base_color=base, transmission_color=base)

    sp_tid = mc[_M_SPTEX].to(torch.int32)
    sp = tex_sample(sp_tid)
    has_sp = sp_tid >= 0
    mat = mat._replace(roughness=torch.where(has_sp, sp[:, 1], mat.roughness),
                       metallic=torch.where(has_sp, sp[:, 2], mat.metallic))

    nm_tid = mc[_M_NMTEX].to(torch.int32)
    nm = tex_sample(nm_tid)
    tn = Vec3((nm[:, 0] * 2.0 - 1.0) * fp.bump_scale,
              (nm[:, 1] * 2.0 - 1.0) * fp.bump_scale,
              nm[:, 2] * 2.0 - 1.0)
    tang = Vec3(c[_A_TAN], c[_A_TAN + 1], c[_A_TAN + 2])
    tang = v3.normalize(tang - n_sh * v3.dot(tang, n_sh))
    hand = c[_A_TAN + 3]
    bitan = v3.cross(n_sh, tang) * hand
    n_mapped = v3.normalize(tang * tn.x + bitan * tn.y + n_sh * tn.z)
    ok_nm = (nm_tid >= 0) & (v3.length(tn) > 1e-4)
    return mat, v3.where(ok_nm, n_mapped, n_sh)


def _scatter_tail(sc: Scene, cfg: Config, fp: FrameParams, carry: Carry,
                  ctx) -> Carry:
    """NEE + BSDF sample + Russian roulette; the LCG ignores path-space
    dims, so the draws are taken in the program's order."""
    p, n_sh, gn, mat, w_o = ctx
    active, throughput, total_t = carry.active, carry.throughput, carry.total_t
    rng_state, pos_sample = _draw2(carry.rng_state)
    rng_state, sel_sample = _draw2(rng_state)
    rng_state, lobe_sample = _draw2(rng_state)
    rng_state, dir_sample = _draw2(rng_state)

    shadow_rays = carry.shadow_rays + active.to(torch.int32)
    cand = _nee_candidate(sc, cfg, p, n_sh, gn, mat, w_o, pos_sample,
                          sel_sample, total_t)
    tmax = torch.where(active, cand.shadow_tmax, cand.eps)
    blocked = sc.walk.occluded(p, cand.dir, cand.eps, tmax)
    visible = (cand.traced & ~blocked) | cand.uncond
    nee_contrib = v3.where(visible, cand.contrib,
                           v3.splat(torch.zeros_like(cand.eps)))
    illum = v3.where(active, carry.illum + throughput * nee_contrib,
                     carry.illum)

    vx, vy = nee_mod.ortho_frame_v(n_sh)
    weight, w_i, _spdf, mis_wpdf = sample_gltf_brdf_v(
        mat, n_sh, w_o, vx, vy, dir_sample, lobe_sample)
    valid_dir = v3.dot(w_i, n_sh) * v3.dot(w_i, gn) > 0.0
    weight_zero = (weight.x == 0.0) & (weight.y == 0.0) & (weight.z == 0.0)
    terminate = (mis_wpdf == 0.0) | weight_zero | ~valid_dir
    keep = active & ~terminate
    throughput = v3.where(keep, throughput * weight, throughput)
    prev_pdf = torch.where(keep, mis_wpdf, carry.prev_pdf)
    active = keep

    foot = carry.foot
    if cfg.has_textures:
        do_ref = active & (v3.dot(w_i, n_sh) * v3.dot(w_o, n_sh) > -0.999)
        ref = _reflect_footprint_v(w_i, carry.rd, *foot)
        foot = tuple(torch.where(do_ref, r, f) for r, f in zip(ref, foot))

    rd = v3.where(active, w_i, carry.rd)
    ro = v3.where(active, p, carry.ro)
    t_min = (v3.length(ro) + total_t) * RAY_EPSILON

    rng_state, rr_sample = lcg.lcg_float(rng_state)
    prefix = v3.max_component(throughput)
    rr_prob = torch.where(carry.bounce_count > 6,
                          torch.clamp(prefix, max=0.95),
                          torch.clamp(prefix, max=1.0))
    do_rr = active & (carry.bounce_count >= fp.rr_path_depth)
    survive = rr_sample < rr_prob
    throughput = v3.where(do_rr & survive,
                          throughput * (1.0 / torch.clamp(rr_prob, min=1e-9)),
                          throughput)
    active = active & (~do_rr | survive)
    return carry._replace(
        ro=ro, rd=rd, t_min=t_min, illum=illum, throughput=throughput,
        active=active, prev_pdf=prev_pdf, rng_state=rng_state,
        shadow_rays=shadow_rays, foot=foot)


def camera_rays(view: View, px, py, dims, j0, j1):
    """Primary rays (pt_megakernel.glsl:315-323)."""
    point_x = (px.to(torch.float32) + 0.5 + (j0 - 0.5)) / dims[0]
    point_y = (py.to(torch.float32) + 0.5 + (j1 - 0.5)) / dims[1]
    du, dv, tl = view.cam_du, view.cam_dv, view.cam_dir_top_left
    rd = v3.normalize(Vec3(
        point_x * du[0] + point_y * dv[0] + tl[0],
        point_x * du[1] + point_y * dv[1] + tl[1],
        point_x * du[2] + point_y * dv[2] + tl[2],
    ))
    shape = px.shape
    ro = Vec3(view.cam_pos[0].expand(shape), view.cam_pos[1].expand(shape),
              view.cam_pos[2].expand(shape))
    return ro, rd


def trace_samples(sc: Scene, cfg: Config, fp: FrameParams, view: View,
                  width: int, height: int, px, py, sample_index, shot: int):
    """One path per lane: pixel (px, py) at sample ``sample_index`` (per
    lane). Returns ((r, g, b, alpha) per lane, closest rays, shadow rays)."""
    dims = (float(width), float(height))
    state = lcg.lcg_seed(sample_index, shot, px.to(torch.int64),
                         py.to(torch.int64), width)
    state, (j0, j1) = _draw2(state)
    ro, rd = camera_rays(view, px, py, dims, j0, j1)
    n = px.shape[0]
    dev = px.device
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    foot = None
    if cfg.has_textures:
        sx = float(np.float32(fp.pixel_radius) / np.float32(dims[0]))
        sy = float(np.float32(fp.pixel_radius) / np.float32(dims[1]))
        dpdx = Vec3(view.cam_du[0] * sx, view.cam_du[1] * sx, view.cam_du[2] * sx)
        dpdy = Vec3(view.cam_dv[0] * sy, view.cam_dv[1] * sy, view.cam_dv[2] * sy)
        foot = _dpdxy_to_footprint_v(rd, dpdx, dpdy)
    carry = Carry(
        ro=ro, rd=rd, t_min=zero, illum=Vec3(zero, zero, zero),
        throughput=Vec3(zero + 1.0, zero + 1.0, zero + 1.0),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        prev_pdf=torch.full((n,), 2.0e16, device=dev),
        bounce_count=torch.zeros(n, dtype=torch.int32, device=dev),
        total_t=zero, rng_state=state,
        closest_rays=torch.zeros(n, dtype=torch.int32, device=dev),
        shadow_rays=torch.zeros(n, dtype=torch.int32, device=dev),
        foot=foot,
    )
    for i in range(cfg.max_path_depth):
        if not bool(carry.active.any()):
            break
        carry, ctx = _visit_hit(sc, cfg, fp, carry)
        if i < cfg.max_path_depth - 1:
            carry = _scatter_tail(sc, cfg, fp, carry, ctx)
    alpha = torch.where(carry.bounce_count == 0, 0.0, 1.0)
    ill = carry.illum
    return (ill.x, ill.y, ill.z, alpha), carry.closest_rays, carry.shadow_rays


def blend(acc, samples, blend_k: int) -> None:
    """The progressive average ``acc += (x - acc) / (k + 1)`` of one sample
    into the four channels ``acc``, in place (process_samples.comp:116-131)."""
    w = float(np.float32(1.0) / (np.float32(blend_k) + np.float32(1.0)))
    for a, smp in zip(acc, samples):
        if blend_k == 0:
            a.copy_(smp)
        else:
            a.add_((smp - a).mul_(w))
