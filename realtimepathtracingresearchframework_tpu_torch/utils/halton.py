"""Halton(2,3) jitter table (librender/halton.h:14).

The reference ships the first 64 entries of the 2D Halton sequence as a
constant table driving the raster-TAA screen jitter
(vulkan/render_vulkan.cpp:2919-2923) and host-side radiance-estimation
sampling (librender/lights.cpp). Generated here by radical inversion —
identical values to the shipped table. The PyTorch port's numpy copy of
the reference's ``utils/halton.py``."""

from __future__ import annotations

import functools

import numpy as np


def radical_inverse(i: int, base: int) -> float:
    inv = 1.0 / base
    f, x = inv, 0.0
    while i > 0:
        x += (i % base) * f
        i //= base
        f *= inv
    return x


@functools.lru_cache(maxsize=4)
def halton_23(n: int = 64) -> np.ndarray:
    """(n, 2) float32 Halton points in bases (2, 3), starting at index 1
    like the reference table (its first entry is (0.5, 1/3))."""
    out = np.empty((n, 2), np.float32)
    for i in range(n):
        out[i, 0] = radical_inverse(i + 1, 2)
        out[i, 1] = radical_inverse(i + 1, 3)
    return out


def halton_jitter(frame_index: int, n: int = 64) -> np.ndarray:
    """Screen jitter for a frame: table entry modulo n, centered to
    [-0.5, 0.5) (the raster-TAA jitter convention)."""
    return halton_23(n)[frame_index % n] - 0.5
