"""Temporal anti-aliasing resolve + temporal reprojection accumulation.

Port of the reference's ``ops/taa.py`` (XLA code there, plain tensor code
here):

- ``taa_resolve``: the TAA compute pass (vulkan/processing/
  process_taa.comp): motion-vector dilation over a 3x3 neighbourhood,
  Lanczos-windowed history reconstruction at the reprojected point,
  exponential blend (new-sample weight 0.15), variance-clamped history
  (neighbourhood mean/stddev trim, :88-106).
- ``reproject_and_accumulate``: REPROJECTION_MODE_ACCUMULATE
  (rendering/postprocess/reprojection.{h,glsl}): history reprojected by the
  motion AOV and blended with a bounded accumulation window
  (process_samples.comp:105-110).

Images are (H, W, C) float32 tensors; every expression keeps the
reference's order of operations.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _pixel_centres(h: int, w: int, device):
    """(H, W, 2) uv of the pixel centres, ((x + 0.5) / w, (y + 0.5) / h)."""
    px = torch.arange(w, device=device)[None, :].repeat(h, 1).to(torch.float32)
    py = torch.arange(h, device=device)[:, None].repeat(1, w).to(torch.float32)
    return torch.stack([(px + 0.5) / w, (py + 0.5) / h], dim=-1)


def _in_bounds(recon):
    return ((recon[..., 0] >= 0.0) & (recon[..., 1] >= 0.0)
            & (recon[..., 0] <= 1.0) & (recon[..., 1] <= 1.0))


def _bilinear_sample(img, uv):
    """img (H, W, C), uv (..., 2) normalised; clamp addressing."""
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0c = torch.clamp(x0, 0, w - 1).long()
    x1c = torch.clamp(x0 + 1, 0, w - 1).long()
    y0c = torch.clamp(y0, 0, h - 1).long()
    y1c = torch.clamp(y0 + 1, 0, h - 1).long()
    p00 = img[y0c, x0c]
    p10 = img[y0c, x1c]
    p01 = img[y1c, x0c]
    p11 = img[y1c, x1c]
    return (p00 * (1 - fx) * (1 - fy) + p10 * fx * (1 - fy)
            + p01 * (1 - fx) * fy + p11 * fx * fy)


def _lanczos_weight(d, pix, radius: int):
    return torch.where(
        torch.abs(d) < 1e-6, 1.0,
        radius * torch.sin(pix) * torch.sin(pix / radius)
        / torch.clamp(pix * pix, min=1e-12))


def _lanczos_sample(img, uv, radius: int = 3):
    """Lanczos-windowed reconstruction (process_taa.comp:28-52), radius 3
    (36 taps) as in the reference. A tap's integer coordinate truncates
    toward zero before the clamp, as the reference's ``astype(int32)``."""
    h, w = img.shape[:2]
    dims = torch.tensor([w, h], dtype=torch.float32, device=img.device)
    point = uv * dims - 0.5
    cpoint = torch.ceil(point)
    accum = torch.zeros(uv.shape[:-1] + (img.shape[-1],), dtype=torch.float32,
                        device=img.device)
    total = torch.zeros(uv.shape[:-1] + (1,), dtype=torch.float32,
                        device=img.device)
    for oy in range(-radius, radius):
        for ox in range(-radius, radius):
            off = torch.tensor([ox, oy], dtype=torch.float32, device=img.device)
            npoint = cpoint + off
            d = npoint - point
            pix = math.pi * d
            wx = _lanczos_weight(d[..., 0], pix[..., 0], radius)
            wy = _lanczos_weight(d[..., 1], pix[..., 1], radius)
            weight = (wx * wy)[..., None]
            xi = torch.clamp(npoint[..., 0].to(torch.int32), 0, w - 1).long()
            yi = torch.clamp(npoint[..., 1].to(torch.int32), 0, h - 1).long()
            accum = accum + weight * img[yi, xi]
            total = total + weight
    return accum / torch.clamp(total, min=1e-8)


def _shift_clamped(img, oy: int, ox: int):
    """Edge-clamped 2D shift (image reads clamp at borders, not wrap)."""
    h, w = img.shape[:2]
    rows = torch.clamp(torch.arange(h, device=img.device) + oy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + ox, 0, w - 1)
    return img[rows][:, cols]


def _neighborhood_stats(img):
    """3x3 mean and "stddev" by shifted adds: the reference's
    9/8 (rms - mean), kept as it is."""
    s = torch.zeros_like(img)
    s2 = torch.zeros_like(img)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            v = _shift_clamped(img, oy, ox)
            s = s + v
            s2 = s2 + v * v
    mean = s / 9.0
    rms = torch.sqrt(s2 / 9.0)
    stddev = 9.0 / 8.0 * (rms - mean)
    return mean, stddev


def taa_resolve(framebuffer, history, motion, new_sample_weight: float = 0.15):
    """framebuffer / history (H, W, 4), motion (H, W, 2) NDC delta.
    Returns the anti-aliased framebuffer (next frame's history)."""
    h, w = framebuffer.shape[:2]
    # motion dilation: the strongest motion in the 3x3 neighbourhood
    best = motion
    best_len = torch.sum(motion * motion, dim=-1)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            m = _shift_clamped(motion, oy, ox)
            ml = torch.sum(m * m, dim=-1)
            take = ml > best_len
            best = torch.where(take[..., None], m, best)
            best_len = torch.where(take, ml, best_len)
    recon = _pixel_centres(h, w, framebuffer.device) + 0.5 * best
    in_bounds = _in_bounds(recon)
    history_color = _lanczos_sample(history, recon)
    mean, stddev = _neighborhood_stats(framebuffer)
    trim_low = torch.clamp(mean - stddev, min=0.0)
    trim_high = torch.maximum(mean + 3.0 * stddev, framebuffer + stddev)
    blended = history_color + (framebuffer - history_color) * new_sample_weight
    blended = torch.minimum(torch.maximum(blended, trim_low), trim_high)
    return torch.where(in_bounds[..., None], blended, framebuffer)


def reproject_and_accumulate(accum, history, motion, depth, history_depth,
                             spp_window: int, sample_base_index: int,
                             batch_size: int):
    """REPROJECTION_MODE_ACCUMULATE (postprocess/reprojection.glsl):
    reproject the linear history by the motion AOV, reject on depth
    disocclusion, blend with the bounded window
    batch / (min(base, window) + batch). accum / history (H, W, 4);
    motion (H, W, 2); depth / history_depth (H, W)."""
    h, w = accum.shape[:2]
    recon = _pixel_centres(h, w, accum.device) + 0.5 * motion
    hist = _bilinear_sample(history, recon)
    hist_d = _bilinear_sample(history_depth[..., None], recon)[..., 0]
    depth_ok = torch.abs(hist_d - depth) <= 0.1 * torch.clamp(
        torch.abs(depth), min=1e-3)
    valid = _in_bounds(recon) & depth_ok
    # the weight in f32 from int32 counts, as the reference computes it
    n_prev = np.minimum(np.float32(sample_base_index), np.float32(spp_window))
    alpha = float(np.float32(batch_size)
                  / np.maximum(n_prev + np.float32(batch_size), np.float32(1.0)))
    blended = hist + (accum - hist) * alpha
    return torch.where(valid[..., None], blended, accum)
