"""Next-event estimation: light sampling + MIS (SoA).

Port of the reference's ``ops/nee.py`` (nee.py:41-342): solid-angle
triangle sampling (rendering/lights/tri.glsl:66-155), uniform and binned
RIS tri-light selection (lights_linear.glsl:20-137), sun spherical-cap
sampling (rendering/lights/sun.glsl) and the balance heuristic
(nee_interface.glsl:11-15). The reference's ``smallgather.select_rows``
(a TPU gather workaround) is plain indexing here, and so is its one-bin
broadcast of the light table (nee.py:183-195), another TPU gather
workaround that computes the same values.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference import vec3 as v3
from perfbench.reference.vec3 import Vec3


class TriLightBuffers(NamedTuple):
    """Emissive triangles as SoA columns on the device."""

    v0: Vec3  # (L,) components
    v1: Vec3
    v2: Vec3
    radiance: Vec3


def light_buffers(v0, v1, v2, radiance, device) -> TriLightBuffers:
    """(L, 3) numpy arrays -> TriLightBuffers on ``device``."""

    def cols(a):
        t = torch.tensor(a, dtype=torch.float32, device=device)
        return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(),
                    t[:, 2].contiguous())

    return TriLightBuffers(cols(v0), cols(v1), cols(v2), cols(radiance))


def ortho_frame_v(n: Vec3):
    """(v_x, v_y) completing n to a right-handed frame (util.glsl:73-93)."""
    zero = torch.zeros_like(n.x)
    one = torch.ones_like(n.x)
    c1 = n.x.abs() < 0.6
    c2 = n.y.abs() < 0.6
    c3 = n.z.abs() < 0.6
    vy = Vec3(
        torch.where(c1 | ~(c2 | c3), one, zero),
        torch.where(~c1 & c2, one, zero),
        torch.where(~c1 & ~c2 & c3, one, zero),
    )
    vx = v3.normalize(v3.cross(vy, n))
    vy = v3.normalize(v3.cross(n, vx))
    return vx, vy


# ---------------------------------------------------------------------------
# Triangle solid angle (tri.glsl:66-155)
# ---------------------------------------------------------------------------


def half_triangle_solid_angle_tan_v(v0: Vec3, v1: Vec3, v2: Vec3):
    """Returns (tangent, params 3-tuple). v* must be unit directions."""
    householder_sign = torch.where(v0.x > 0.0, -1.0, 1.0)
    inv = 1.0 / (v0.x.abs() + 1.0)
    hh_y = v0.y * inv
    hh_z = v0.z * inv
    dot_0_1 = v3.dot(v0, v1)
    dot_0_2 = v3.dot(v1, v2)
    dot_1_2 = v3.dot(v0, v2)
    dot_h0 = -householder_sign * v1.x + dot_0_1
    dot_h2 = -householder_sign * v2.x + dot_1_2
    col0_y = -dot_h0 * hh_y + v1.y
    col0_z = -dot_h0 * hh_z + v1.z
    col1_y = -dot_h2 * hh_y + v2.y
    col1_z = -dot_h2 * hh_z + v2.z
    simplex_volume = (col0_y * col1_z - col0_z * col1_y).abs()
    dot_0_2_plus_1_2 = dot_0_2 + dot_1_2
    one_plus_dot_0_1 = 1.0 + dot_0_1
    tangent = simplex_volume / (one_plus_dot_0_1 + dot_0_2_plus_1_2)
    return tangent, (simplex_volume, dot_0_2_plus_1_2, one_plus_dot_0_1)


def _positive_atan(t):
    a = torch.atan(t)
    return torch.where(a >= 0.0, a, a + math.pi)


def triangle_solid_angle_v(v0: Vec3, v1: Vec3, v2: Vec3):
    tangent, params = half_triangle_solid_angle_tan_v(v0, v1, v2)
    return 2.0 * _positive_atan(tangent), params


def approx_triangle_solid_angle_v(v0: Vec3, v1: Vec3, v2: Vec3):
    tangent, _ = half_triangle_solid_angle_tan_v(v0, v1, v2)
    return 2.0 * _positive_atan(tangent)


def is_tri_facing_forward_v(v0: Vec3, v1: Vec3, v2: Vec3):
    return v3.dot(v3.cross(v0, v1), v2) < 0.0


def sample_solid_angle_polygon_v(
    v0: Vec3, v1: Vec3, v2: Vec3, solid_angle, params, u0, u1
) -> Vec3:
    """Peters' clipped-arc sampling (tri.glsl:132-155). v* unit dirs."""
    target = solid_angle * u0
    cs = torch.cos(0.5 * target)
    sn = torch.sin(0.5 * target)
    # vertices[3] = {v1, v0, v2}
    offset = v1 * (params[0] * cs - params[1] * sn) + v2 * (params[2] * sn)
    d = v3.dot(v1, offset) / torch.clamp(v3.dot(offset, offset), min=1e-30)
    new_v2 = offset * (2.0 * d) - v1
    s2 = v3.dot(v0, new_v2)
    s = 1.0 + (s2 - 1.0) * u1
    denominator = 1.0 - s2 * s2
    t_normed = torch.sqrt(
        torch.clamp(1.0 - s * s, min=0.0)
        / torch.clamp(denominator, min=1e-30)
    )
    t_normed = torch.where(denominator > 0.0, t_normed, u1)
    return v0 * (s - t_normed * s2) + new_v2 * t_normed


# ---------------------------------------------------------------------------
# Tri-light sampling (lights_linear.glsl:20-127)
# ---------------------------------------------------------------------------

MIN_IRRADIANCE = 6.2e-4 * 0.001  # lights_linear.glsl:40


class LightSample(NamedTuple):
    illum: Vec3  # radiance / pdf
    dir: Vec3
    dist: torch.Tensor
    pdf: torch.Tensor
    mis_wpdf: torch.Tensor


def _fetch(cols: Vec3, idx) -> Vec3:
    return Vec3(cols.x[idx], cols.y[idx], cols.z[idx])


def sample_tri_lights_v(
    lights: TriLightBuffers,
    hit_p: Vec3,
    hit_n: Vec3,
    dir_sample,
    sel_sample,
    bin_size: int = 16,
    use_bins: bool = False,
) -> LightSample:
    """Batched tri-light sample. ``dir_sample``/``sel_sample`` are (u0, u1)
    tuples. ``use_bins``: binned RIS selection (nee.py:161-256), a uniform
    bin pick, then the bin's ``bin_size`` lights scored by luminance x
    approximate solid angle where the light faces the hit point and lies
    above its normal ``hit_n``, and one picked by the scores' CDF; the
    light table length is then a multiple of ``bin_size`` (padded with
    zero-radiance lights, ``lights.equalize_emitter_bins``). Otherwise a
    uniform pick over every light."""
    num_lights = lights.v0.x.shape[0]
    if use_bins:
        num_bins = num_lights // bin_size
        sx = sel_sample[0] * num_bins
        bin_id = torch.clamp(sx.to(torch.int32), max=num_bins - 1).to(torch.int64)
        lid = bin_id[..., None] * bin_size + torch.arange(
            bin_size, device=sx.device)  # (N, B)

        def gat(col):
            return Vec3(col.x[lid] - hit_p.x[..., None],
                        col.y[lid] - hit_p.y[..., None],
                        col.z[lid] - hit_p.z[..., None])

        lv0, lv1, lv2 = gat(lights.v0), gat(lights.v1), gat(lights.v2)
        contrib = v3.luminance(lights.radiance)[lid]
        front = is_tri_facing_forward_v(lv0, lv1, lv2)
        n_b = Vec3(hit_n.x[..., None], hit_n.y[..., None], hit_n.z[..., None])
        above = ((v3.dot(lv0, n_b) > 0.0) | (v3.dot(lv1, n_b) > 0.0)
                 | (v3.dot(lv2, n_b) > 0.0))
        sa = approx_triangle_solid_angle_v(
            v3.normalize(lv0), v3.normalize(lv1), v3.normalize(lv2))
        contrib = torch.where(above & front, contrib * sa, 0.0) + MIN_IRRADIANCE
        p = contrib / contrib.sum(dim=-1, keepdim=True)
        cdf = torch.cumsum(p, dim=-1)
        k = (sel_sample[1][..., None] >= cdf).sum(dim=-1)
        k = torch.clamp(k, max=bin_size - 1)
        pk = p.gather(-1, k[..., None])[..., 0]
        light_id = bin_id * bin_size + k
        sel_p = (1.0 / num_bins) * pk
        mis_den = float(num_bins)
    else:
        sx = sel_sample[0] * num_lights
        light_id = torch.clamp(sx.to(torch.int32),
                               max=num_lights - 1).to(torch.int64)
        sel_p = torch.full(light_id.shape, 1.0 / num_lights, device=sx.device)
        mis_den = float(num_lights)

    lv0 = _fetch(lights.v0, light_id)
    lv1 = _fetch(lights.v1, light_id)
    lv2 = _fetch(lights.v2, light_id)
    radiance = _fetch(lights.radiance, light_id)

    d0 = v3.normalize(lv0 - hit_p)
    d1 = v3.normalize(lv1 - hit_p)
    d2 = v3.normalize(lv2 - hit_p)
    sa, params = triangle_solid_angle_v(d0, d1, d2)
    light_dir = sample_solid_angle_polygon_v(
        d0, d1, d2, sa, params, dir_sample[0], dir_sample[1]
    )
    pdf = 1.0 / torch.clamp(sa, min=1e-12)

    e0 = lv1 - lv0
    e1 = lv2 - lv0
    e_n = v3.cross(e0, e1)
    denom = v3.dot(light_dir, e_n)
    light_dist = v3.dot(lv0 - hit_p, e_n) / torch.where(
        denom.abs() > 1e-20, denom, 1e-20
    )
    mis_wpdf = 2.0 * light_dist * light_dist / torch.clamp(denom.abs(), min=1e-20)

    pdf = pdf * sel_p
    mis_wpdf = mis_wpdf / mis_den
    illum = radiance * (1.0 / torch.clamp(pdf, min=1e-30))
    # degenerate (zero-area or zero-radiance padding) -> no contribution
    bad = (sa <= 1e-12) | ~(light_dist > 0.0)
    zero = v3.splat(torch.zeros_like(pdf))
    return LightSample(
        illum=v3.where(bad, zero, illum),
        dir=light_dir,
        dist=torch.where(bad, 2.0e16, light_dist),
        pdf=torch.where(bad, 0.0, pdf),
        mis_wpdf=torch.where(bad, 0.0, mis_wpdf),
    )


def approx_tri_lights_pdf(approx_solid_angle, num_lights, num_bins, use_bins):
    """(lights_linear.glsl:129-137)"""
    n = num_bins if use_bins else num_lights
    return 1.0 / (n * torch.clamp(approx_solid_angle, min=1e-12))


# ---------------------------------------------------------------------------
# Sun (sun.glsl + mc/lights_sun.glsl)
# ---------------------------------------------------------------------------


def sample_sun_dir_v(sun_dir: torch.Tensor, cos_radius, u0, u1) -> Vec3:
    """Spherical-cap sun sampling; ``sun_dir`` is a (3,) tensor."""
    sd = v3.from_array(sun_dir)
    phi = 2.0 * math.pi * u0
    cos_t = 1.0 + (cos_radius - 1.0) * u1
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    vx, vy = ortho_frame_v(sd)
    lx = sin_t * torch.cos(phi)
    ly = sin_t * torch.sin(phi)
    return vx * lx + vy * ly + sd * cos_t


def sun_dir_pdf(cos_radius):
    return 1.0 / (2.0 * math.pi * (1.0 - cos_radius))


def nee_mis_heuristic(n_f, pdf_f, n_g, pdf_g):
    """Balance heuristic (nee_interface.glsl:11-15)."""
    f = n_f * pdf_f
    g = n_g * pdf_g
    return f / torch.clamp(f + g, min=1e-30)
