"""What the integrator and the fused shading stage (``ops/shade.py``)
share: the scene tables' column layout, their per-lane fetch, the
material of a fetched row, the sky term of a miss, the texture footprint
and its transforms, and the wavefront's deferred shadow queue.

``csrc/shade.cu`` is compiled for this layout: ``LAYOUT`` lists the numbers
it hard-codes, and ``ops/shade.py`` refuses to launch a library that
reports others.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realtimepathtracingresearchframework_tpu_torch.models.material import (
    BASE_MATERIAL_ONESIDED,
    BASE_MATERIAL_THIN,
)
from realtimepathtracingresearchframework_tpu_torch.models.sky import sky_radiance_v
from realtimepathtracingresearchframework_tpu_torch.ops import nee as nee_mod
from realtimepathtracingresearchframework_tpu_torch.ops import vec3 as v3
from realtimepathtracingresearchframework_tpu_torch.ops.bsdf_gltf import GLTFMaterial
from realtimepathtracingresearchframework_tpu_torch.ops.texture_atlas import MAX_MIPS
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

RAY_EPSILON = 5.0e-6  # vulkan/gpu_params.glsl:28


# ---------------------------------------------------------------------------
# Scene tables, stored TRANSPOSED as (W, T) f32 like the reference's: a
# fetch of one row range by a per-lane index gives one contiguous 1-D
# tensor per attribute (the SoA layout the shading math wants). Integer
# columns are float VALUES (exact below 2^24), never bit patterns.
# ---------------------------------------------------------------------------

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
_M_FLAGS, _M_BCTEX, _M_SPTEX, _M_NMTEX = 9, 10, 11, 12  # float values
_M_CCGLOSS = 13  # clearcoat_gloss (thin-transmission reflective roughness)


# the numbers csrc/shade.cu is compiled for, under the names of its
# constexprs (and reported by its rptr_shade_layout)
LAYOUT = {
    "kAttrW": ATTR_W, "kMatW": MAT_W, "kMaxMips": MAX_MIPS,
    "kAE1": _A_E1, "kAE2": _A_E2, "kAN0": _A_N0, "kAN1": _A_N1,
    "kAN2": _A_N2, "kAUV0": _A_UV0, "kAUV1": _A_UV1, "kAUV2": _A_UV2,
    "kATan": _A_TAN, "kADens": _A_DENS, "kAMid": _A_MID,
    "kMBase": _M_BASE, "kMRough": _M_ROUGH, "kMSpec": _M_SPEC,
    "kMMetal": _M_METAL, "kMIor": _M_IOR, "kMStrans": _M_STRANS,
    "kMEmit": _M_EMIT, "kMFlags": _M_FLAGS, "kMBctex": _M_BCTEX,
    "kMSptex": _M_SPTEX, "kMNmtex": _M_NMTEX,
    "kOnesided": BASE_MATERIAL_ONESIDED, "kRayEpsilon": RAY_EPSILON,
}


def _fetch_cols_ranges(tbl_t, idx, ranges):
    """Fetch the table rows in ``ranges`` at per-lane index ``idx``:
    {absolute_row: (N,) column}."""
    rows = [r for a, b in ranges for r in range(a, b)]
    sub = torch.cat([tbl_t[a:b] for a, b in ranges], dim=0)
    cols = sub.index_select(1, idx)
    return {r: cols[i] for i, r in enumerate(rows)}


def _material_from_cols(c, thin: bool = False) -> GLTFMaterial:
    """Fetched material columns -> SoA GLTFMaterial. ``thin`` applies the
    THIN_TRANSMISSION load rule (gltf_bsdf.glsl:47-56)."""
    base = Vec3(c[_M_BASE], c[_M_BASE + 1], c[_M_BASE + 2])
    flags = c[_M_FLAGS].to(torch.int32)
    roughness = c[_M_ROUGH]
    transmission_roughness = None
    if thin:
        thin_lane = (
            ((flags & BASE_MATERIAL_THIN) != 0)
            & (c[_M_STRANS] > 0.0)
            & (c[_M_IOR] > 1.0)
        )
        transmission_roughness = roughness
        roughness = torch.where(thin_lane, torch.sqrt(c[_M_CCGLOSS]), roughness)
    return GLTFMaterial(
        base_color=base,
        metallic=c[_M_METAL],
        specular=c[_M_SPEC],
        roughness=roughness,
        ior=c[_M_IOR],
        specular_transmission=c[_M_STRANS],
        transmission_color=base,
        onesided=(flags & BASE_MATERIAL_ONESIDED) != 0,
        transmission_roughness=transmission_roughness,
    )


def _ocean(y):
    """0.7*(1-|y|)^5 below the horizon (pt_megakernel.glsl:118-122), with
    the fifth power multiplied out as XLA does."""
    a = torch.clamp(1.0 - y.abs(), min=0.0)
    a2 = a * a
    return torch.where(y <= 0.0, 0.7 * (a * (a2 * a2)), 1.0)


def _sky_illum(ds, rd: Vec3, prev_pdf, cfg) -> Vec3:
    """compute_sky_illum (pt_megakernel.glsl:113-149)."""
    zero = v3.splat(torch.zeros_like(rd.x))
    if not cfg.enable_sun_sky:
        return zero
    atm = v3.vabs(sky_radiance_v(ds.sky, rd))
    # sun disk with MIS vs NEE sun sampling
    ocean = _ocean(rd.y)
    dm = v3.normalize(Vec3(rd.x, rd.y.abs(), rd.z))
    sd = ds.sky.sun_dir
    in_cap = (dm.x * sd[0] + dm.y * sd[1] + dm.z * sd[2]) >= ds.sky.sun_cos_angle
    sr = ds.sky.sun_radiance
    sun = v3.where(
        in_cap, Vec3(sr[0] * ocean, sr[1] * ocean, sr[2] * ocean), zero
    )
    light_pdf = sr[3] * nee_mod.sun_dir_pdf(ds.sky.sun_cos_angle)
    w = nee_mod.nee_mis_heuristic(1.0, prev_pdf, 1.0, light_pdf)
    return atm + v3.vabs(sun) * w


class Footprint(NamedTuple):
    """Per-lane ray-differential texture footprint: the symmetric 2x2
    covariance (F00, F11, F01) of footprint.glsl."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor


class PendingNEE(NamedTuple):
    """The wavefront's deferred NEE shadow ray of each lane
    (integrator.py:1526-1531), resolved by the next ``visit_hit``."""

    dir: Vec3
    tmin: torch.Tensor
    tmax: torch.Tensor
    contrib: Vec3  # throughput-scaled contribution if unblocked
    traced: torch.Tensor  # bool: a shadow ray is queued for this lane


def empty_pend(like) -> PendingNEE:
    """No queued shadow ray, on ``like``'s lanes."""
    z = torch.zeros_like(like)
    return PendingNEE(Vec3(z, z + 1.0, z), z, z, Vec3(z, z, z),
                      torch.zeros(like.shape, dtype=torch.bool, device=like.device))


def _mat3_apply(m, x: Vec3) -> Vec3:
    """Per-lane (N, 9) row-major 3x3 matrices times a Vec3 (the
    reference's ``einsum("nab,nb->na")``)."""
    return Vec3(*(m[:, 3 * a] * x.x + m[:, 3 * a + 1] * x.y + m[:, 3 * a + 2] * x.z
                  for a in range(3)))


# ---------------------------------------------------------------------------
# Ray-differential texture footprint (rt/footprint.glsl; integrator.py:
# 1752-1830)
# ---------------------------------------------------------------------------


def _dpdxy_to_footprint_v(rd: Vec3, dpdx: Vec3, dpdy: Vec3):
    """dpdxy_to_footprint (footprint.glsl:10-15): the symmetric 2x2
    covariance of the pixel differentials in the ray-perpendicular basis,
    stored as (F00, F11, F01)."""
    t, b = nee_mod.ortho_frame_v(rd)
    tx, ty = v3.dot(t, dpdx), v3.dot(t, dpdy)
    bx, by = v3.dot(b, dpdx), v3.dot(b, dpdy)
    return Footprint(tx * tx + ty * ty, bx * bx + by * by, tx * bx + ty * by)


def _footprint_to_dpdxy_v(rd: Vec3, fa, fb, fc):
    """footprint_to_dpdxy (footprint.glsl:44-61): eigen-decompose F back
    into two world-space differential vectors."""
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
    dpdx = Vec3(
        (t.x * x0x + b.x * x0y) * s0,
        (t.y * x0x + b.y * x0y) * s0,
        (t.z * x0x + b.z * x0y) * s0,
    )
    dpdy = Vec3(
        (t.x * x1x + b.x * x1y) * s1,
        (t.y * x1x + b.y * x1y) * s1,
        (t.z * x1x + b.z * x1y) * s1,
    )
    return dpdx, dpdy


def _reflect_footprint_v(w_i: Vec3, rd: Vec3, fa, fb, fc):
    """reflect_footprint (footprint.glsl:37-42): mirror the footprint
    across the half-vector and re-express it in the new ray's basis."""
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
    return Footprint(
        m00 * t00 + m01 * t01,
        m10 * t10 + m11 * t11,
        m00 * t10 + m01 * t11,
    )
