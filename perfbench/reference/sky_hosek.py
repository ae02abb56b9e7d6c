"""Hosek-Wilkie sky model: host-side coefficient cooking + solar radiance.

Port of the analytic skylight/solar radiance model of Hosek & Wilkie
(SIGGRAPH 2012 / IEEE CG&A 2013) as used by the reference
(rendering/lights/sky_model_arhosek/sky_model.cpp, wired in
vulkan/render_sky.cpp:25-72). The fitted coefficient tables are loaded
from ``hosek_sky.npz`` beside this file (published data under the
3-clause BSD license of the original sample code).

Host precompute only — runtime per-miss evaluation lives in
``sky.py`` (sky_model.glsl semantics, including its use of
``gamma = acos(cos_theta)`` in the exp term, preserved for image parity
with the reference GPU path).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_HALF_PI = np.pi / 2.0
TERRESTRIAL_SOLAR_RADIUS = np.radians(0.51) / 2.0  # sky_model.cpp:320


@functools.lru_cache(maxsize=1)
def _data():
    path = os.path.join(os.path.dirname(__file__), "hosek_sky.npz")
    # materialize: NpzFile re-decompresses the zip member on EVERY
    # __getitem__ (measured 111 ms per sky cook from repeated reads)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _bezier_weights(x: float) -> np.ndarray:
    """Quintic bezier weights over normalized solar elevation
    (ArHosekSkyModel_CookConfiguration, sky_model.cpp:150-231)."""
    ix = 1.0 - x
    return np.array(
        [ix**5, 5.0 * ix**4 * x, 10.0 * ix**3 * x**2,
         10.0 * ix**2 * x**3, 5.0 * ix * x**4, x**5],
        np.float64,
    )


def _cook(dataset: np.ndarray, turbidity: float, albedo: float,
          solar_elevation: float) -> np.ndarray:
    """Cook configuration/radiance coefficients for one or more channels.

    ``dataset``: (..., 2, 10, 6, K) with albedo lo/hi, turbidity 1..10,
    6 bezier knots. Returns (..., K). Bilinear in (albedo,
    frac(turbidity)), quintic bezier in cbrt-normalized elevation —
    sky_model.cpp:150-293."""
    int_turb = int(np.clip(turbidity, 1.0, 10.0))
    rem = float(np.clip(turbidity, 1.0, 10.0)) - int_turb
    x = (max(solar_elevation, 0.0) / _HALF_PI) ** (1.0 / 3.0)
    bez = _bezier_weights(x)

    def eval_at(alb_idx: int, turb_idx: int) -> np.ndarray:
        knots = dataset[..., alb_idx, turb_idx, :, :]  # (..., 6, K)
        return np.einsum("j,...jk->...k", bez, knots)

    cfg = (1.0 - albedo) * (1.0 - rem) * eval_at(0, int_turb - 1)
    cfg = cfg + albedo * (1.0 - rem) * eval_at(1, int_turb - 1)
    if int_turb < 10:
        cfg = cfg + (1.0 - albedo) * rem * eval_at(0, int_turb)
        cfg = cfg + albedo * rem * eval_at(1, int_turb)
    return cfg


def rgb_state(turbidity: float, albedo: float, elevation: float):
    """arhosek_rgb_skymodelstate_alloc_init (sky_model.cpp:607-642):
    returns (configs (3, 9), radiances (3,)) for sRGB channels."""
    d = _data()
    configs = _cook(d["rgb"], turbidity, albedo, elevation)
    radiances = _cook(d["rgb_rad"][..., None], turbidity, albedo, elevation)[..., 0]
    return configs, radiances


_PIECES = 45  # sky_model.cpp:659-660
_ORDER = 4


def _sr_internal(solar, turb_idx: int, wl_idx: int, elevation: float) -> float:
    """arhosekskymodel_sr_internal (sky_model.cpp:662-691): piecewise
    cubic in cbrt-warped elevation. ``solar``: (11, 10, 45, 4), stored
    low-to-high coefficient order (the C walks a flat pointer backwards
    from order*(pos+1)-1, i.e. coeff [pos][3] down to [pos][0] with
    ascending powers of x)."""
    pos = int((2.0 * elevation / np.pi) ** (1.0 / 3.0) * _PIECES)
    pos = min(pos, _PIECES - 1)
    break_x = (pos / _PIECES) ** 3.0 * _HALF_PI
    x = elevation - break_x
    coefs = solar[wl_idx, turb_idx, pos]  # (4,), C index order
    res, x_exp = 0.0, 1.0
    for i in range(_ORDER):
        res += x_exp * coefs[_ORDER - 1 - i]
        x_exp *= x
    return res


def solar_radiance_direct(turbidity: float, wavelength: float,
                          elevation: float, gamma: float) -> float:
    """arhosekskymodel_solar_radiance_internal2 (sky_model.cpp:697-795):
    direct solar disc radiance with limb darkening (terrestrial
    correction factors 1)."""
    d = _data()
    solar, limb = d["solar"], d["limb"]
    turbidity = float(np.clip(turbidity, 1.0, 10.0))
    turb_low = int(turbidity) - 1
    turb_frac = turbidity - (turb_low + 1)
    if turb_low == 9:
        turb_low, turb_frac = 8, 1.0
    wl_low = int((wavelength - 320.0) / 40.0)
    wl_frac = np.fmod(wavelength, 40.0) / 40.0
    if wl_low == 10:
        wl_low, wl_frac = 9, 1.0

    direct = (1.0 - turb_frac) * (
        (1.0 - wl_frac) * _sr_internal(solar, turb_low, wl_low, elevation)
        + wl_frac * _sr_internal(solar, turb_low, wl_low + 1, elevation)
    ) + turb_frac * (
        (1.0 - wl_frac) * _sr_internal(solar, turb_low + 1, wl_low, elevation)
        + wl_frac * _sr_internal(solar, turb_low + 1, wl_low + 1, elevation)
    )

    ld = (1.0 - wl_frac) * limb[wl_low] + wl_frac * limb[wl_low + 1]
    sol_rad_sin = np.sin(TERRESTRIAL_SOLAR_RADIUS)
    ar2 = 1.0 / (sol_rad_sin * sol_rad_sin)
    sin_g = np.sin(gamma)
    sc2 = max(1.0 - ar2 * sin_g * sin_g, 0.0)
    sample_cos = np.sqrt(sc2)
    darkening = sum(ld[i] * sample_cos**i for i in range(6))
    return float(direct * darkening)


_XYZ_TO_SRGB = np.array(  # color_matching.glsl:87-92
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    np.float64,
)

_CM_CIE_MIN, _CM_CIE_MAX, _CM_CIE_SAMPLES = 360.0, 830.0, 95


def sun_disc_radiance_rgb(sun_y: float, turbidity: float, albedo: float):
    """The sun-disc radiance integration of update_sky_light
    (render_sky.cpp:41-66): spectral (solar - inscattered) radiance
    sampled at the CIE table wavelengths up to 720nm, integrated to XYZ,
    converted to sRGB and scaled by 0.01. Mirrors the reference's quirk of
    passing ``sun_dir.y`` where angles are expected. Returns (3,) or None
    when the sun is below the horizon / the integral went negative."""
    d = _data()
    cie = d["cie1931"]  # (3, 95)
    xyz = np.zeros(3)
    num, last_wl = 0, _CM_CIE_MIN
    elevation = _HALF_PI - sun_y  # solar_radiance: (pi/2 - theta)
    for i in range(_CM_CIE_SAMPLES):
        wl = i * (_CM_CIE_MAX - _CM_CIE_MIN) / (_CM_CIE_SAMPLES - 1) + _CM_CIE_MIN
        if wl > 720.0:
            break
        # render_sky.cpp takes solar_radiance (direct + inscattered) and
        # subtracts arhosekskymodel_radiance (the inscatter the sky dome
        # already provides) — net effect: the direct term alone
        rad = solar_radiance_direct(turbidity, wl, elevation, 0.0)
        xyz += cie[:, i] * rad
        num += 1
        last_wl = wl
    xyz *= (last_wl - _CM_CIE_MIN) / num
    if sun_y > 0.0 and np.all(xyz >= 0.0):
        return 0.01 * (_XYZ_TO_SRGB @ xyz)
    return None
