"""Analytic sun + sky light: the device half of the reference's
``models/sky.py`` (sky.py:123-368).

``build_sky`` is the host precompute (render_sky.cpp:25-72): the Hosek-
Wilkie RGB configs and radiances come from the reference's jax-free cook
(``models/sky_hosek.py``), with the Preetham (Perez) model as the fallback
when the Hosek data file is absent. ``sky_radiance_v`` is the per-miss
evaluation (sky_model.glsl), quirks included. The reference's opt-in baked
equirect map is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.models import sky_hosek
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

SUN_APPARENT_ANGLE_DEG = 0.53


class SkyParams(NamedTuple):
    """Device-side sky/sun parameters (f32 tensors on one device)."""

    perez: torch.Tensor  # (3,5) A..E for Y, x, y
    zenith: torch.Tensor  # (3,) Yz, xz, yz
    sun_dir: torch.Tensor  # (3,)
    sun_cos_angle: torch.Tensor  # ()
    sun_radiance: torch.Tensor  # (4,): rgb + NEE selection weight
    scale: torch.Tensor  # () overall radiance scale
    # Hosek-Wilkie RGB state: (9, 3) selects the Hosek evaluation, (1, 3)
    # means Preetham
    hosek_configs: torch.Tensor
    hosek_radiances: torch.Tensor


def _perez_coeffs(t: float) -> np.ndarray:
    """Preetham Perez coefficients for (Y, x, y) as functions of turbidity."""
    return np.array(
        [
            [0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
             0.1206 * t - 2.5771, -0.0670 * t + 0.3703],
            [-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
             -0.0641 * t - 0.8989, -0.0033 * t + 0.0452],
            [-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
             -0.0441 * t - 1.6537, -0.0109 * t + 0.0529],
        ],
        np.float64,
    )


def _zenith_values(t: float, theta_s: float) -> np.ndarray:
    """Zenith luminance (kcd/m^2) and chromaticity for turbidity t and sun
    zenith angle theta_s (radians)."""
    chi = (4.0 / 9.0 - t / 120.0) * (np.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * np.tan(chi) - 0.2155 * t + 2.4192
    yz = max(yz, 1e-4)

    t2, ts = t * t, theta_s
    vec = np.array([ts**3, ts**2, ts, 1.0])
    xz = (
        np.array([0.00166, -0.00375, 0.00209, 0.0]) @ vec * t2
        + np.array([-0.02903, 0.06377, -0.03202, 0.00394]) @ vec * t
        + np.array([0.11693, -0.21196, 0.06052, 0.25886]) @ vec
    )
    yz_c = (
        np.array([0.00275, -0.00610, 0.00317, 0.0]) @ vec * t2
        + np.array([-0.04214, 0.08970, -0.04153, 0.00516]) @ vec * t
        + np.array([0.15346, -0.26756, 0.06670, 0.26688]) @ vec
    )
    return np.array([yz, xz, yz_c], np.float64)


_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float64,
)


def _sun_radiance_rgb(sun_y: float, turbidity: float) -> np.ndarray:
    """Approximate clear-sky solar disk radiance (linear sRGB) for the
    Preetham fallback: Bird-style optical mass, warmed toward the
    horizon."""
    if sun_y <= 0.0:
        return np.zeros(3)
    cos_z = sun_y
    m = 1.0 / (cos_z + 0.15 * (93.885 - np.degrees(np.arccos(cos_z))) ** -1.253)
    beta = 0.04608 * turbidity - 0.04586
    lam = np.array([0.62, 0.55, 0.46])
    tau_r = np.exp(-m * 0.008735 * lam**-4.08)
    tau_a = np.exp(-m * beta * lam**-1.3)
    return 1.5e4 * tau_r * tau_a


def _params(device, sun_dir, sun_radiance, scale, perez=None, zenith=None,
            configs=None, radiances=None) -> SkyParams:
    def f32(a):  # contiguous: the fused shading kernel reads the tables flat
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)

    return SkyParams(
        perez=f32(np.zeros((3, 5)) if perez is None else perez),
        zenith=f32(np.zeros(3) if zenith is None else zenith),
        sun_dir=f32(sun_dir),
        sun_cos_angle=f32(np.cos(np.radians(SUN_APPARENT_ANGLE_DEG) / 2.0)),
        sun_radiance=f32(sun_radiance),
        scale=f32(scale),
        hosek_configs=f32(np.zeros((1, 3)) if configs is None else configs),
        hosek_radiances=f32(np.zeros(3) if radiances is None else radiances),
    )


def build_sky(sun_dir, turbidity: float = 3.0, albedo=(0.2, 0.2, 0.2),
              has_area_lights: bool = False, scale: float = 0.025,
              model: str = "hosek", device="cpu") -> SkyParams:
    """Host precompute (the update_sky_light analogue, render_sky.cpp:25-72).
    ``model``: "hosek" (reference parity, default) or "preetham"."""
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    w = 0.5 if has_area_lights else 1.0
    if model == "hosek" and sky_hosek.hosek_data_available():
        # elevation = sun_dir.y: the reference passes the cosine where the
        # model expects an angle (preserved), albedo averaged
        alb = float(np.dot(np.asarray(albedo, np.float64), np.full(3, 1.0 / 3.0)))
        configs, radiances = sky_hosek.rgb_state(
            float(turbidity), alb, float(sun_dir[1])
        )
        sun_rgb = sky_hosek.sun_disc_radiance_rgb(
            float(sun_dir[1]), float(turbidity), alb
        )
        if sun_rgb is not None:
            sun_radiance = np.array([*sun_rgb, w], np.float64)
        else:
            sun_radiance = np.zeros(4)
            if not has_area_lights:
                sun_radiance[3] = 1.0
        return _params(device, sun_dir, sun_radiance, 1.0,
                       configs=configs.T, radiances=radiances)

    theta_s = np.arccos(np.clip(sun_dir[1], -1.0, 1.0))
    perez = _perez_coeffs(float(turbidity))
    zenith = _zenith_values(float(turbidity), float(min(theta_s, np.pi / 2 - 1e-3)))
    sun_rgb = _sun_radiance_rgb(float(sun_dir[1]), float(turbidity))
    if sun_dir[1] > 0.0 and np.all(sun_rgb >= 0.0):
        sun_radiance = np.array([*(scale * sun_rgb), w], np.float64)
    else:
        sun_radiance = np.zeros(4)
        if not has_area_lights:
            sun_radiance[3] = 1.0
    return _params(device, sun_dir, sun_radiance, scale, perez=perez,
                   zenith=zenith)


def _perez(coeffs, cos_theta, gamma, cos_gamma):
    a, b, c, d, e = (coeffs[..., i] for i in range(5))
    return (1.0 + a * torch.exp(b / torch.clamp(cos_theta, min=0.01))) * (
        1.0 + c * torch.exp(d * gamma) + e * cos_gamma * cos_gamma
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

    if params.hosek_configs.shape[0] == 9:
        # sky_model.glsl:46-48: gamma = acos(cosTheta)
        h_gamma = torch.acos(cos_theta)
        r = _hosek_channel(params, 0, cos_theta, h_gamma, cos_gamma)
        g = _hosek_channel(params, 1, cos_theta, h_gamma, cos_gamma)
        b = _hosek_channel(params, 2, cos_theta, h_gamma, cos_gamma)
        s = params.scale * ocean
        return Vec3(r * s, g * s, b * s)

    gamma = torch.acos(cos_gamma)
    theta_s = torch.acos(torch.clamp(sd[1], 0.0, 1.0))
    cos_theta_s = torch.cos(theta_s)

    def ratio(i):
        f = _perez(params.perez[i], cos_theta, gamma, cos_gamma)
        f0 = _perez(params.perez[i], torch.ones_like(theta_s), theta_s,
                    cos_theta_s)
        return params.zenith[i] * f / torch.clamp(f0, min=1e-9)

    lum = ratio(0)  # kcd/m^2
    x = ratio(1)
    yc = torch.clamp(ratio(2), min=1e-6)

    # xyY -> XYZ -> sRGB, written per channel
    X = x / yc * lum
    Z = (1.0 - x - yc) / yc * lum
    m = _XYZ_TO_SRGB.astype(np.float32)
    s = params.scale * ocean
    r = torch.clamp(float(m[0, 0]) * X + float(m[0, 1]) * lum + float(m[0, 2]) * Z, min=0.0) * s
    g = torch.clamp(float(m[1, 0]) * X + float(m[1, 1]) * lum + float(m[1, 2]) * Z, min=0.0) * s
    b = torch.clamp(float(m[2, 0]) * X + float(m[2, 1]) * lum + float(m[2, 2]) * Z, min=0.0) * s
    return Vec3(r, g, b)
