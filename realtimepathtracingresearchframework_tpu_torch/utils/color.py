"""Color-space conversions and tonemapping operators.

Semantics match the reference so golden images agree:
- sRGB encode: ``rendering/util.glsl:25-37``
- tonemap modes NO/NEUTRAL/FAST: ``rendering/postprocess/tonemapping_utils.glsl``
- luminance weights: ``ext/libvkr/src/vkr.c:76`` (Rec.709)

Host-side numpy copy for the PyTorch port (the device resolve is
ops/resolve.py).
"""

from __future__ import annotations

import numpy as np

TONEMAP_NO = 0
TONEMAP_NEUTRAL = 1
TONEMAP_FAST = 2


def _xp(x):
    return np


def luminance(c):
    """Rec.709 luminance; c[..., 3]."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def linear_to_srgb(x):
    xp = _xp(x)
    x = xp.maximum(x, 0.0)
    return xp.where(
        x <= 0.0031308, 12.92 * x, 1.055 * xp.power(x, 1.0 / 2.4) - 0.055
    )


def srgb_to_linear(x):
    xp = _xp(x)
    x = xp.maximum(x, 0.0)
    return xp.where(x <= 0.04045, x / 12.92, xp.power((x + 0.055) / 1.055, 2.4))


def neutral_tone_map_rgb(r, g, b):
    """Channel-separate neutral operator — the ONE home of the rolloff
    constants, shared by the packed path below and the planar resolve
    (ops/resolve.py), so a parity fix cannot drift between them."""
    xp = _xp(r)
    lum = xp.maximum(xp.maximum(r, g), xp.maximum(b, 1.0))
    t = 0.1 * xp.log2(lum)
    s = (t + (1.0 - t) * 0.8) / lum
    return r * s, g * s, b * s


def neutral_tone_map(c):
    """Log-luminance rolloff operator (tonemapping_utils.glsl:10-16)."""
    xp = _xp(c)
    r, g, b = neutral_tone_map_rgb(c[..., 0], c[..., 1], c[..., 2])
    return xp.stack([r, g, b], axis=-1)


def fast_tone_map_rgb(r, g, b):
    """Channel-separate Reinhard (shared with ops/resolve.py)."""
    return r / (1.0 + r), g / (1.0 + g), b / (1.0 + b)


def fast_tone_map(c):
    """Reinhard c/(1+c) (tonemapping_utils.glsl:24-27)."""
    return c / (1.0 + c)


def tonemap(mode: int, c):
    """Static-mode tonemap dispatch (tonemapping_utils.glsl:18-36).

    ``mode`` must be a Python int (folded at trace time, like the
    reference's compile-time dispatch).
    """
    if mode == TONEMAP_NEUTRAL:
        return neutral_tone_map(c)
    if mode == TONEMAP_FAST:
        return fast_tone_map(c)
    return c
