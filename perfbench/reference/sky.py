"""Analytic sun + sky light: the device half of the reference's
``models/sky.py`` (sky.py:123-368).

``build_sky`` is the host precompute (render_sky.cpp:25-72): the Hosek-
Wilkie RGB configs and radiances cooked by ``sky_hosek.py`` from
``hosek_sky.npz``. ``sky_radiance_v`` is the per-miss evaluation
(sky_model.glsl), quirks included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import sky_hosek
from perfbench.reference.vec3 import Vec3

SUN_APPARENT_ANGLE_DEG = 0.53


class SkyParams(NamedTuple):
    """Device-side sky/sun parameters (f32 tensors on one device)."""

    sun_dir: torch.Tensor  # (3,)
    sun_cos_angle: torch.Tensor  # ()
    sun_radiance: torch.Tensor  # (4,): rgb + NEE selection weight
    hosek_configs: torch.Tensor  # (9, 3): Hosek-Wilkie RGB configuration
    hosek_radiances: torch.Tensor  # (3,)


def build_sky(sun_dir, turbidity: float = 3.0, albedo=(0.2, 0.2, 0.2),
              has_area_lights: bool = False, device="cpu") -> SkyParams:
    """Host precompute (the update_sky_light analogue, render_sky.cpp:25-72)
    of the Hosek-Wilkie sky; its tables (``hosek_sky.npz``) are required."""
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    w = 0.5 if has_area_lights else 1.0
    # elevation = sun_dir.y: the reference passes the cosine where the
    # model expects an angle (preserved), albedo averaged
    alb = float(np.dot(np.asarray(albedo, np.float64), np.full(3, 1.0 / 3.0)))
    configs, radiances = sky_hosek.rgb_state(float(turbidity), alb,
                                             float(sun_dir[1]))
    sun_rgb = sky_hosek.sun_disc_radiance_rgb(float(sun_dir[1]),
                                              float(turbidity), alb)
    if sun_rgb is not None:
        sun_radiance = np.array([*sun_rgb, w], np.float64)
    else:
        sun_radiance = np.zeros(4)
        if not has_area_lights:
            sun_radiance[3] = 1.0

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    return SkyParams(
        sun_dir=f32(sun_dir),
        sun_cos_angle=f32(np.cos(np.radians(SUN_APPARENT_ANGLE_DEG) / 2.0)),
        sun_radiance=f32(sun_radiance),
        hosek_configs=f32(configs.T),
        hosek_radiances=f32(radiances),
    )


def _hosek_channel(params: SkyParams, ch: int, cos_theta, gamma, cos_gamma):
    """skymodel_radiance for one sRGB channel (sky_model.glsl:40-61),
    including its ``gamma = acos(cosTheta)`` in the exp term."""
    c = [params.hosek_configs[i, ch] for i in range(9)]
    exp_m = torch.exp(c[4] * gamma)
    ray_m = cos_gamma * cos_gamma
    mie_m = (1.0 + cos_gamma * cos_gamma) / torch.pow(
        torch.clamp(1.0 + c[8] * c[8] - 2.0 * c[8] * cos_gamma, min=1e-12), 1.5
    )
    zenith = torch.sqrt(cos_theta)
    coeffs = (1.0 + c[0] * torch.exp(c[1] / (cos_theta + 0.01))) * (
        c[2] + c[3] * exp_m + c[5] * ray_m + c[6] * mie_m + c[7] * zenith
    )
    return coeffs * params.hosek_radiances[ch] * 0.01


def sky_radiance_v(params: SkyParams, d: Vec3) -> Vec3:
    """Atmosphere radiance for directions ``d`` (Vec3), linear sRGB.
    Downward directions are mirrored with the reference's ocean
    attenuation 0.7*(1-|y|)^5 (pt_megakernel.glsl:118-122). Does NOT
    include the sun disk."""
    y = d.y
    a = torch.clamp(1.0 - y.abs(), min=0.0)
    a2 = a * a
    ocean = torch.where(y <= 0.0, 0.7 * (a * (a2 * a2)), 1.0)
    ay = y.abs()
    inv = 1.0 / torch.sqrt(torch.clamp(d.x * d.x + ay * ay + d.z * d.z, min=1e-40))
    mx, my, mz = d.x * inv, ay * inv, d.z * inv

    cos_theta = torch.clamp(my, 0.0, 1.0)
    sd = params.sun_dir
    cos_gamma = torch.clamp(mx * sd[0] + my * sd[1] + mz * sd[2], -1.0, 1.0)

    # sky_model.glsl:46-48: gamma = acos(cosTheta)
    h_gamma = torch.acos(cos_theta)
    r = _hosek_channel(params, 0, cos_theta, h_gamma, cos_gamma)
    g = _hosek_channel(params, 1, cos_theta, h_gamma, cos_gamma)
    b = _hosek_channel(params, 2, cos_theta, h_gamma, cos_gamma)
    return Vec3(r * ocean, g * ocean, b * ocean)
