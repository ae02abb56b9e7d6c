"""RNG pointsets — uniform (LCG) variant.

Port of the reference's ``ops/rng.py`` (murmur3-seeded 32-bit LCG,
rendering/pointsets/lcg_rng.glsl:28-39, hashing.glsl:11-39), bit-exact
with its u32 outputs.

PyTorch's CPU ``uint32`` has no add, shift or compare kernels, so the
state is carried as ``int64`` holding a value in [0, 2^32) and masked with
``& 0xFFFFFFFF`` after every multiply, add and shift. A 32x32-bit product
does not fit a signed 64-bit lane, so multiplies by a constant go through
``_mul32``, which splits the constant into 16-bit halves.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """Any integer tensor (or Python int) -> int64 tensor holding its
    value mod 2^32."""
    return torch.as_tensor(x).to(torch.int64) & M32


def _mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32). ``c`` is a Python int or an
    int64 tensor in [0, 2^32). Each partial product stays below 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def murmur_hash3_mix(h, k):
    """(hashing.glsl:11-28)"""
    h = _u32(h)
    k = _u32(k)
    k = _mul32(k, 0xCC9E2D51)
    k = _rotl(k, 15)
    k = _mul32(k, 0x1B873593)
    h = h ^ k
    h = (_mul32(_rotl(h, 13), 5) + 0xE6546B64) & M32
    return h


def murmur_hash3_finalize(h):
    """(hashing.glsl:30-39)"""
    h = _u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


# LCG constants (lcg_rng.glsl:16-18, from OSPRay)
_LCG_M = 1664525
_LCG_N = 1013904223


def lcg_seed(sample_index, shot, pixel_x, pixel_y, width):
    """get_lcg_rng (lcg_rng.glsl:28-39): state for one path."""
    linear = (_u32(pixel_x) + _mul32(_u32(pixel_y), _u32(width))) & M32
    state = murmur_hash3_mix(_u32(shot), linear)
    state = murmur_hash3_mix(state, _u32(sample_index))
    return murmur_hash3_finalize(state)


def lcg_step(state):
    return (_mul32(state, _LCG_M) + _LCG_N) & M32


def lcg_float(state):
    """Returns (new_state, float in [0,1)) — ldexp(float(u32), -32)."""
    state = lcg_step(state)
    return state, state.to(torch.float32) * (2.0**-32)
