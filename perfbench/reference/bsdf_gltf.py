"""GLTF layered BSDF (branchless, SoA).

Port of the reference's ``ops/bsdf_gltf.py`` (bsdf_gltf.py:57-498; the
production BSDF of rendering/bsdfs/gltf_bsdf.glsl:294-659): GLTF-2.0
metal/dielectric mix with a diffuse lobe, GGX specular with Smith
height-correlated visibility and spherical-caps VNDF sampling, rough
specular transmission (not the thin-transmission mode: no cell's scene
has a thin material, and the reference refuses one), the luminance-weighted component sampler and
the approximate MIS weight-pdf. Control flow is mask-based
(``torch.where``) over batched shading points; directions and colors are
``Vec3`` triples. Expression order follows the reference term by term, and
integer powers are written as the multiplications XLA lowers them to.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference import vec3 as v3
from perfbench.reference.vec3 import Vec3

M_1_PI = 1.0 / math.pi
MIN_ALPHA = 0.002


class GLTFMaterial(NamedTuple):
    base_color: Vec3
    metallic: torch.Tensor
    specular: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    specular_transmission: torch.Tensor
    transmission_color: Vec3
    onesided: torch.Tensor  # bool


def schlick_weight(c):
    x = torch.clamp(1.0 - c, 0.0, 1.0)
    x2 = x * x
    return x2 * x2 * x


def gltf_schlick_weight(o_dot_h, ior):
    """Schlick with critical-angle fixup for ior < 1 (gltf_bsdf.glsl:288-292)."""
    f = schlick_weight(o_dot_h)
    cos_critical = torch.sqrt(torch.clamp(1.0 - ior * ior, min=0.0))
    fix = torch.clamp(
        (1.0 - o_dot_h) / torch.clamp(1.0 - cos_critical, min=1e-9), max=1.0
    )
    return torch.where(ior < 1.0, f + (1.0 - f) * fix, f)


def gtr_2(cos_theta_h, alpha):
    a2 = alpha * alpha
    d = 1.0 + (a2 - 1.0) * cos_theta_h * cos_theta_h
    return M_1_PI * a2 / (d * d)


def smith_visibility_den1(n_dot_o, alpha_sq):
    return n_dot_o.abs() + torch.sqrt(
        alpha_sq + (1.0 - alpha_sq) * n_dot_o * n_dot_o
    )


def smith_visibility_ggx(n_dot_o, n_dot_i, alpha_g):
    a = alpha_g * alpha_g
    return 1.0 / (
        smith_visibility_den1(n_dot_i, a) * smith_visibility_den1(n_dot_o, a)
    )


def gtr_2_vndf_pdf(n_dot_o, cos_theta_h, alpha):
    return gtr_2(cos_theta_h, alpha) * (
        0.5 / smith_visibility_den1(n_dot_o, alpha * alpha)
    )


def to_pipe_sample_v(u0, u1) -> Vec3:
    phi = 2.0 * math.pi * u0
    return Vec3(torch.cos(phi), torch.sin(phi), u1)


def sample_sphere_v(up: Vec3) -> Vec3:
    cos_t = up.z * 2.0 - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return Vec3(sin_t * up.x, sin_t * up.y, cos_t)


def sample_gtr_2_vndf_v(w_o_local: Vec3, alpha, up: Vec3) -> Vec3:
    """Spherical-caps VNDF sampling (gltf_bsdf.glsl:233-256)."""
    wi_std = v3.normalize(
        Vec3(alpha * w_o_local.x, alpha * w_o_local.y, w_o_local.z), eps=0.0
    )
    z = (1.0 - up.z) * (1.0 + wi_std.z) - wi_std.z
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    wm_std = Vec3(sin_t * up.x + wi_std.x, sin_t * up.y + wi_std.y, z + wi_std.z)
    wm = Vec3(wm_std.x * alpha, wm_std.y * alpha, torch.clamp(wm_std.z, min=0.0))
    return v3.normalize(wm)


def gltf_diffuse_basecolor(mat: GLTFMaterial):
    return (1.0 - mat.metallic) * mat.base_color


def gltf_specular_basecolor(mat: GLTFMaterial, ior):
    r = (ior - 1.0) / (ior + 1.0)
    d = r * r
    return mat.base_color * mat.metallic + v3.splat(d * (1.0 - mat.metallic))


def gltf_specular_alpha(mat: GLTFMaterial):
    return torch.clamp(mat.roughness * mat.roughness, min=MIN_ALPHA)


def cos_half_angle(cos_angle):
    return (1.0 + cos_angle) / torch.sqrt(
        torch.clamp(2.0 + 2.0 * cos_angle, min=1e-12)
    )


def _half_vector_v(mat, n: Vec3, w_o: Vec3, w_i: Vec3, i_dot_n, o_dot_n, ior):
    """w_h construction incl. transmission cases (gltf_bsdf.glsl:296-320).
    Returns (w_h, valid, transmit)."""
    transmit = i_dot_n * o_dot_n < 0.0
    w_h_refl = w_i + w_o
    w_h_trans_onesided = -(ior * w_i) - w_o
    w_h_trans_twosided = v3.reflect(w_i, n) + w_o
    w_h_trans = v3.where(mat.onesided, w_h_trans_onesided, w_h_trans_twosided)
    w_h = v3.normalize(v3.where(transmit, w_h_trans, w_h_refl))
    valid = ~transmit | (
        (mat.specular_transmission > 0.0) & (v3.dot(w_h, n) > 0.0)
    )
    return w_h, valid, transmit


def gltf_bsdf_v(mat: GLTFMaterial, n: Vec3, w_o: Vec3, w_i: Vec3) -> Vec3:
    """Full BSDF value (gltf_bsdf.glsl:294-391)."""
    i_dot_n = v3.dot(n, w_i)
    o_dot_n = v3.dot(n, w_o)
    ior = torch.where(o_dot_n < 0.0, 1.0 / mat.ior, mat.ior)

    w_h, valid, transmit = _half_vector_v(
        mat, n, w_o, w_i, i_dot_n, o_dot_n, ior
    )
    o_dot_h = v3.dot(w_o, w_h)
    i_dot_h = v3.dot(w_i, w_h)

    diffuse = gltf_diffuse_basecolor(mat) * M_1_PI

    f0 = gltf_specular_basecolor(mat, mat.ior)
    alpha = gltf_specular_alpha(mat)
    spec_refl = gtr_2(v3.dot(n, w_h), alpha) * smith_visibility_ggx(
        o_dot_n, i_dot_n, alpha
    )
    f_weight = gltf_schlick_weight(o_dot_h.abs(), ior)
    F = f0 + (1.0 - f0) * f_weight

    has_specular = mat.ior > 1.0
    zero = v3.splat(torch.zeros_like(o_dot_n))

    # reflection side
    diffuse_refl = diffuse * (1.0 - mat.specular_transmission) * (1.0 - F)
    spec_side_refl = F * spec_refl

    # transmission side
    compression = 2.0 * o_dot_h / (i_dot_h * ior + o_dot_h)
    comp2 = torch.where(mat.onesided, compression * compression, 1.0)
    spec_side_trans = (
        mat.transmission_color * (1.0 - F)
    ) * (spec_refl * (1.0 - mat.metallic) * mat.specular_transmission * comp2)

    refl_val = v3.where(has_specular, diffuse_refl + spec_side_refl, diffuse)
    trans_val = v3.where(has_specular, spec_side_trans, zero)
    out = v3.where(transmit, trans_val, refl_val)
    return v3.where(valid, out, zero)


def _component_weights_v(mat, ior, odh, vis):
    """Luminance-weighted component sampler (gltf_bsdf.glsl:369-395).
    Returns normalized (w0, w1, w2)."""
    spec_lum = v3.luminance(gltf_specular_basecolor(mat, mat.ior))
    one = torch.ones_like(ior)
    f0 = spec_lum + (1.0 - spec_lum) * gltf_schlick_weight(odh[0], one)
    f1 = spec_lum + (1.0 - spec_lum) * gltf_schlick_weight(odh[1], one)

    diff_lum = v3.luminance(gltf_diffuse_basecolor(mat))
    w0 = (1.0 - f0) * vis[0] * (1.0 - mat.metallic) * diff_lum
    w0 = w0 * (1.0 - mat.specular_transmission)
    f2 = spec_lum + (1.0 - spec_lum) * gltf_schlick_weight(odh[2], ior)
    w2 = (
        (1.0 - f2) * vis[2] * (1.0 - mat.metallic)
        * mat.specular_transmission
    )
    w1 = f1 * vis[1]
    total = w0 + w1 + w2
    pos = total > 0.0
    inv = 1.0 / torch.clamp(total, min=1e-30)
    w0n = torch.where(pos, w0 * inv, 1.0)
    w1n = torch.where(pos, w1 * inv, 0.0)
    w2n = torch.where(pos, w2 * inv, 0.0)
    return w0n, w1n, w2n


def gltf_wpdf_v(mat: GLTFMaterial, n: Vec3, w_o: Vec3, w_i: Vec3):
    """Approximate MIS weight-pdf (gltf_wpdf, gltf_bsdf.glsl:414-497)."""
    i_dot_n = v3.dot(n, w_i)
    o_dot_n = v3.dot(n, w_o)
    ior = torch.where(o_dot_n < 0.0, 1.0 / mat.ior, mat.ior)

    diffuse_pdf = M_1_PI * i_dot_n.abs()

    w_h, valid, transmit = _half_vector_v(
        mat, n, w_o, w_i, i_dot_n, o_dot_n, ior
    )
    o_dot_h = v3.dot(w_o, w_h)
    i_dot_h = v3.dot(w_i, w_h)
    cos_theta_h = v3.dot(w_h, n)

    alpha = gltf_specular_alpha(mat)
    vis_spec = 2.0 * i_dot_n.abs() / smith_visibility_den1(i_dot_n, alpha * alpha)
    aodh = o_dot_h.abs()
    w0, w1, w2 = _component_weights_v(
        mat, ior, (aodh, aodh, aodh),
        (torch.ones_like(vis_spec), vis_spec, vis_spec),
    )

    specular = gtr_2_vndf_pdf(o_dot_n, cos_theta_h, alpha)
    pdf_refl = diffuse_pdf * w0 + specular * w1
    compression = 2.0 * o_dot_h / (i_dot_h * ior + o_dot_h)
    comp2 = torch.where(mat.onesided, compression * compression, 1.0)
    pdf_trans = specular * comp2 * w2
    pdf = torch.where(transmit, pdf_trans, pdf_refl)
    pdf = torch.where(mat.ior > 1.0, pdf, diffuse_pdf)
    return torch.where(valid, pdf, 0.0)


def sample_gltf_brdf_v(
    mat: GLTFMaterial, n: Vec3, w_o: Vec3, v_x: Vec3, v_y: Vec3,
    dir_sample, lobe_sample,
):
    """Sample the BSDF (sample_gltf_brdf, gltf_bsdf.glsl:500-652).

    ``dir_sample``/``lobe_sample`` are (u0, u1) tuples of 1-D tensors.
    Returns (weight = f*|cos|/pdf Vec3, w_i Vec3, pdf, mis_wpdf);
    pdf == 0 marks invalid samples.
    """
    w_o_local = Vec3(v3.dot(w_o, v_x), v3.dot(w_o, v_y), v3.dot(w_o, n))
    o_dot_n = w_o_local.z
    ior = torch.where(o_dot_n < 0.0, 1.0 / mat.ior, mat.ior)
    # flip into upper hemisphere for sampling
    w_o_up = Vec3(w_o_local.x, w_o_local.y, o_dot_n.abs())

    up = to_pipe_sample_v(dir_sample[0], dir_sample[1])
    w_i_diffuse = v3.normalize(n + sample_sphere_v(up))
    w_i_diffuse = v3.where(o_dot_n < 0.0, -w_i_diffuse, w_i_diffuse)

    alpha = gltf_specular_alpha(mat)

    # candidate half vectors + visibilities for component weighting
    w_h_spec_local = sample_gtr_2_vndf_v(w_o_up, alpha, up)
    odh_diffuse = cos_half_angle(v3.dot(w_o, w_i_diffuse))
    odh_spec = v3.dot(w_o_up, w_h_spec_local)
    spec_i_dot_n = v3.reflect(-w_o_up, w_h_spec_local).z
    vis_spec = torch.where(
        spec_i_dot_n > 0.0,
        2.0 * spec_i_dot_n / smith_visibility_den1(spec_i_dot_n, alpha * alpha),
        0.0,
    )
    refr, _tir = v3.refract(-w_o_up, w_h_spec_local, 1.0 / ior)
    trans_i_dot_n = torch.where(mat.onesided, -refr.z, spec_i_dot_n)
    vis_trans = torch.where(
        (trans_i_dot_n > 0.0) & (mat.specular_transmission > 0.0),
        2.0 * trans_i_dot_n
        / smith_visibility_den1(trans_i_dot_n, alpha * alpha),
        0.0,
    )

    w0, w1, w2 = _component_weights_v(
        mat, ior, (odh_diffuse, odh_spec, odh_spec),
        (torch.ones_like(vis_spec), vis_spec, vis_trans),
    )
    # materials without a specular layer (ior <= 1) always take diffuse
    has_spec_layer = mat.ior > 1.0
    w0 = torch.where(has_spec_layer, w0, 1.0)
    w1 = torch.where(has_spec_layer, w1, 0.0)
    w2 = torch.where(has_spec_layer, w2, 0.0)

    # CDF component selection: rounding can leave w0 + w1 just below 1
    # without transmission, and an r in that gap picks component 2 with
    # zero weight (the path terminates).
    cdf1 = w0
    cdf2 = w0 + w1
    r = lobe_sample[0]
    component = torch.where(
        r < cdf1, 0, torch.where(r < cdf2, 1, 2)
    )
    wsel = torch.where(
        component == 0, w0, torch.where(component == 1, w1, w2)
    )

    w_h_pick_local = w_h_spec_local
    w_h_local_signed = Vec3(
        w_h_pick_local.x,
        w_h_pick_local.y,
        w_h_pick_local.z * torch.where(o_dot_n < 0.0, -1.0, 1.0),
    )
    cos_theta_h_spec = w_h_local_signed.z
    w_h_world = (
        w_h_local_signed.x * v_x
        + w_h_local_signed.y * v_y
        + w_h_local_signed.z * n
    )
    w_i_spec = v3.reflect(-w_o, w_h_world)
    is_diff = component == 0
    is_spec = component == 1
    refr_w, _ = v3.refract(-w_o, w_h_world, 1.0 / ior)
    w_i_trans = v3.where(mat.onesided, refr_w, v3.reflect(w_i_spec, n))
    w_i = v3.where(
        is_diff, w_i_diffuse, v3.where(is_spec, w_i_spec, w_i_trans)
    )

    i_dot_n = v3.dot(n, w_i)
    # sign consistency (gltf_bsdf.glsl:617-623)
    ok = torch.where(
        component == 2, i_dot_n * o_dot_n < 0.0, i_dot_n * o_dot_n > 0.0
    )
    ok = ok & (wsel > 0.0)

    # sampling pdf (gltf_bsdf.glsl:626-648)
    w_h_sel = v3.where(is_diff, v3.normalize(w_i + w_o), w_h_world)
    o_dot_h = v3.dot(w_o, w_h_sel)
    cos_theta_h = torch.where(is_diff, v3.dot(n, w_h_sel), cos_theta_h_spec)

    diffuse_pdf = M_1_PI * i_dot_n.abs()
    specular = gtr_2_vndf_pdf(o_dot_n, cos_theta_h, alpha)
    pdf_refl = diffuse_pdf * w0 + specular * w1
    i_dot_h = torch.where(
        (component == 2) & mat.onesided, v3.dot(w_i, w_h_sel), o_dot_h
    )
    compression = 2.0 * o_dot_h / (i_dot_h * ior + o_dot_h)
    comp2 = torch.where(mat.onesided, compression * compression, 1.0)
    pdf_trans = specular * comp2 * w2
    pdf = torch.where(component == 2, pdf_trans, pdf_refl)
    pdf = torch.where(mat.ior > 1.0, pdf, diffuse_pdf)
    pdf = torch.where(ok & (pdf > 0.0), pdf, 0.0)

    f = gltf_bsdf_v(mat, n, w_o, w_i)
    mis_wpdf = gltf_wpdf_v(mat, n, w_o, w_i)
    good = pdf > 0.0
    weight = v3.where(
        good,
        f * (i_dot_n.abs() / torch.clamp(pdf, min=1e-30)),
        v3.splat(torch.zeros_like(pdf)),
    )
    mis_wpdf = torch.where(good, mis_wpdf, 0.0)
    return weight, w_i, pdf, mis_wpdf
