"""Sample processing / resolve.

Port of the reference's ``ops/resolve.py`` (vulkan/process_samples.comp):
the progressive history average of the image-domain path
(``accumulate_history``, resolve.py:25-38), and the resolve: exposure
``exp2``, the optional early tonemap (utils/color.py operators) and the
sRGB encode, channel-separate over 1-D linear accumulation buffers
(``resolve_channels``, resolve.py:41-57) or over an (H, W, 4) image with
integer upscale replication (``resolve_framebuffer``, resolve.py:60-81).
"""

from __future__ import annotations

import numpy as np
import torch

TONEMAP_MODE_NEUTRAL = 1
TONEMAP_MODE_FAST = 2


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


def accumulate_history(history, new_accum, sample_base_index: int,
                       batch_size: int):
    """Progressive average of (H, W, 4) images (process_samples.comp:
    116-131): ``new_accum`` is the MEAN of this batch's ``batch_size``
    samples (``render_tile_host`` blends from base 0), so the running mean
    is ``history + (mean - history) * batch / (base + batch)``; a base of
    0 takes ``new_accum`` as it is. The weight is computed in f32, as the
    reference computes it on the device."""
    if sample_base_index <= 0:
        return new_accum.clone()
    n = np.float32(np.int32(sample_base_index) + np.int32(batch_size))
    w = float(np.float32(batch_size) / np.maximum(n, np.float32(1.0)))
    return history + (new_accum - history) * w


def _exposure_scale(exposure: float, device):
    """exp2(exposure) in f32 on ``device``."""
    return torch.exp2(torch.tensor(exposure, dtype=torch.float32)).to(device)


def _tone_map(r, g, b, tonemap_mode: int):
    if tonemap_mode == TONEMAP_MODE_NEUTRAL:
        return neutral_tone_map_rgb(r, g, b)
    if tonemap_mode == TONEMAP_MODE_FAST:
        return fast_tone_map_rgb(r, g, b)
    return r, g, b


def resolve_channels(channels, exposure: float, tonemap_mode: int = -1):
    """(r, g, b, a) 1-D linear accumulation buffers -> (r, g, b, a) sRGB
    display buffers."""
    scale = _exposure_scale(exposure, channels[0].device)
    r, g, b = channels[0] * scale, channels[1] * scale, channels[2] * scale
    a = torch.clamp(channels[3], max=1.0)
    r, g, b = _tone_map(r, g, b, tonemap_mode)
    return (linear_to_srgb(r), linear_to_srgb(g), linear_to_srgb(b), a)


def resolve_framebuffer(accum, exposure: float, tonemap_mode: int = -1,
                        upscale: int = 1):
    """accum (H, W, 4) linear -> display framebuffer (H*u, W*u, 4) sRGB,
    each pixel replicated over a u x u block (process_samples.comp:
    183-199)."""
    scale = _exposure_scale(exposure, accum.device)
    rgb = accum[..., :3] * scale
    r, g, b = _tone_map(rgb[..., 0], rgb[..., 1], rgb[..., 2], tonemap_mode)
    out = torch.stack([linear_to_srgb(r), linear_to_srgb(g), linear_to_srgb(b),
                       torch.clamp(accum[..., 3], max=1.0)], dim=-1)
    if upscale > 1:
        out = out.repeat_interleave(upscale, dim=0).repeat_interleave(
            upscale, dim=1)
    return out
