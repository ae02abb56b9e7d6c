"""Sample processing / resolve.

Port of the reference's ``ops/resolve.py::resolve_channels``
(resolve.py:41-60; vulkan/process_samples.comp): exposure ``exp2``, the
optional early tonemap (utils/color.py operators) and the sRGB encode,
channel-separate over 1-D linear accumulation buffers.
"""

from __future__ import annotations

import torch

from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    TONEMAP_MODE_FAST,
    TONEMAP_MODE_NEUTRAL,
)


def linear_to_srgb(x):
    """rendering/util.glsl:25-37"""
    x = torch.clamp(x, min=0.0)
    return torch.where(
        x <= 0.0031308, 12.92 * x, 1.055 * torch.pow(x, 1.0 / 2.4) - 0.055
    )


def neutral_tone_map_rgb(r, g, b):
    """Log-luminance rolloff (tonemapping_utils.glsl:10-16)."""
    lum = torch.maximum(torch.maximum(r, g), torch.clamp(b, min=1.0))
    t = 0.1 * torch.log2(lum)
    s = (t + (1.0 - t) * 0.8) / lum
    return r * s, g * s, b * s


def fast_tone_map_rgb(r, g, b):
    """Reinhard c/(1+c) (tonemapping_utils.glsl:24-27)."""
    return r / (1.0 + r), g / (1.0 + g), b / (1.0 + b)


def resolve_channels(channels, exposure: float, tonemap_mode: int = -1):
    """(r, g, b, a) 1-D linear accumulation buffers -> (r, g, b, a) sRGB
    display buffers."""
    scale = torch.exp2(torch.tensor(exposure, dtype=torch.float32))
    scale = scale.to(channels[0].device)
    r, g, b = channels[0] * scale, channels[1] * scale, channels[2] * scale
    a = torch.clamp(channels[3], max=1.0)
    if tonemap_mode == TONEMAP_MODE_NEUTRAL:
        r, g, b = neutral_tone_map_rgb(r, g, b)
    elif tonemap_mode == TONEMAP_MODE_FAST:
        r, g, b = fast_tone_map_rgb(r, g, b)
    return (linear_to_srgb(r), linear_to_srgb(g), linear_to_srgb(b), a)
