"""Sobol low-discrepancy sequences (host matrix generation + tensor eval).

Port of the reference's ``ops/sobol.py`` (sobol.py:27-193): the
self-generated direction matrices that the Sobol, Z-Sobol and blue-noise
variants use when the pointset tables are not taken (``tables="never"``),
the Laine-Karras hash, Owen scrambling, Morton interleave and the XOR fold
of a Sobol sample.

``sobol_matrices`` and its primitive-polynomial search are host numpy,
kept as a copy under the reference's names
(``tests/test_torch_host_copies.py`` holds it to the original). The tensor
functions carry u32 values as ``int64`` masked to 32 bits, as
``ops/rng.py`` does: CPU torch ``uint32`` has no add, shift or compare.
Every value is masked before a right shift and after every product.

``sobol_value`` folds 32 index bits one at a time, as the reference does;
it is the oracle of ``fold_tables`` / ``fold``, which fold the index a
byte at a time through a (4, 256) table per dimension (XOR is linear, so
the two are bitwise equal) in four gathers instead of 32 steps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops.rng import M32, _mul32

SOBOL_BITS = 32
SOBOL_DIMS = 128


# ---------------------------------------------------------------------------
# GF(2) primitive polynomial search (host, cached; sobol.py:37-100)
# ---------------------------------------------------------------------------


def _poly_mulmod(a: int, b: int, mod: int, deg: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> deg & 1:
            a ^= mod
    return r


def _is_primitive(poly: int, deg: int) -> bool:
    """poly: bitmask including x^deg term. Primitive iff x has order 2^deg-1
    in GF(2)[x]/poly."""
    order = (1 << deg) - 1

    def powx(e):
        result = 1
        base = 2  # x
        while e:
            if e & 1:
                result = _poly_mulmod(result, base, poly, deg)
            base = _poly_mulmod(base, base, poly, deg)
            e >>= 1
        return result

    if powx(order) != 1:
        return False
    n = order
    ps = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            ps.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        ps.append(n)
    return all(powx(order // p) != 1 for p in ps)


@functools.lru_cache(maxsize=None)
def _primitive_polys(count: int):
    """First ``count`` primitive polynomials by degree, as (degree,
    interior coefficients a_1..a_{s-1}) in the Joe-Kuo convention."""
    polys = []
    deg = 1
    while len(polys) < count:
        for interior in range(1 << max(deg - 1, 0)):
            poly = (1 << deg) | 1
            for i in range(deg - 1):
                if interior >> i & 1:
                    poly |= 1 << (i + 1)
            if _is_primitive(poly, deg):
                polys.append((deg, interior))
                if len(polys) >= count:
                    break
        deg += 1
    return polys


@functools.lru_cache(maxsize=None)
def sobol_matrices(dims: int = SOBOL_DIMS) -> np.ndarray:
    """(dims, 32) uint32 direction vectors v_k (MSB-aligned)."""
    rng = np.random.default_rng(0x50B0)
    mats = np.zeros((dims, SOBOL_BITS), np.uint32)
    for k in range(SOBOL_BITS):  # dimension 0: van der Corput
        mats[0, k] = 1 << (31 - k)
    polys = _primitive_polys(dims - 1)
    for d in range(1, dims):
        s, interior = polys[d - 1]
        # deterministic odd initial direction numbers m_i < 2^i
        m = np.zeros(SOBOL_BITS, np.uint64)
        for i in range(s):
            m[i] = (rng.integers(0, 1 << i) * 2 + 1) if i > 0 else 1
        for i in range(s, SOBOL_BITS):
            mi = m[i - s] ^ ((1 << s) * m[i - s])
            for k in range(1, s):
                if interior >> (k - 1) & 1:
                    mi ^= (1 << k) * m[i - k]
            m[i] = mi
        for k in range(SOBOL_BITS):
            mats[d, k] = np.uint32(m[k] << np.uint64(31 - k))
    return mats


# ---------------------------------------------------------------------------
# Tensor evaluation (sobol.py:127-193), u32 values in int64
# ---------------------------------------------------------------------------


def _lk_hash(x, seed):
    """Laine-Karras permutation-style hash (reversed-bit Owen scramble).
    ``seed`` is a tensor or a Python int."""
    x = (x + seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def _reverse_bits(x):
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) | (x >> 16)) & M32


def owen_scramble(x, seed):
    """Hash-based Owen scrambling of a radical-inverse value (u32)."""
    return _reverse_bits(_lk_hash(_reverse_bits(x), seed))


def morton2d(x, y):
    """Interleave two 16-bit ints -> 32-bit Morton code."""

    def expand(v):
        v = v.to(torch.int64) & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555

    return expand(x) | (expand(y) << 1)


def sobol_value(matrices: torch.Tensor, index, dim: int):
    """u32 Sobol sample: XOR of the matrix columns of ``dim`` selected by
    the 32 bits of ``index``, one bit at a time (the reference's fold; the
    oracle of ``fold``). ``matrices`` (D, 32) int64; ``dim`` is clamped to
    the table as the reference's ``dynamic_slice`` clamps it."""
    col = matrices[min(max(int(dim), 0), matrices.shape[0] - 1)]
    val = torch.zeros_like(index)
    for k in range(SOBOL_BITS):
        val = val ^ (col[k] * ((index >> k) & 1))
    return val


def fold_tables(matrices: np.ndarray) -> np.ndarray:
    """(D, 32) u32 direction numbers -> (D, 4, 256) int64 byte tables:
    entry [d, j, b] is the XOR of the columns 8j..8j+7 of dimension d that
    the bits of byte value b select."""
    cols = np.asarray(matrices, np.uint32).astype(np.int64).reshape(-1, 4, 1, 8)
    bits = ((np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1).astype(bool)
    return np.bitwise_xor.reduce(np.where(bits[None, None], cols, 0), axis=-1)


def fold(table: torch.Tensor, index):
    """The XOR fold of one dimension's byte tables ``table`` (4, 256) over
    the u32 ``index``: four gathers, bitwise ``sobol_value``."""
    val = table[0][index & 0xFF]
    for j in (1, 2, 3):
        val = val ^ table[j][(index >> (8 * j)) & 0xFF]
    return val


def u32_to_float(x):
    return x.to(torch.float32) * (2.0**-32)
