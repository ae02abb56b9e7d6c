"""Quantized scene-data codecs (vectorized numpy).

The `.vks` format stores, per mesh:
- vertex positions as u64: 3x21-bit unsigned fixed point
  (decode: ``q_axis * scale[axis] + offset[axis]``; bit fields x=0..20,
  y=21..41, z=42..62 — reference ``librender/dequantize.glsl:8-21``),
- normals+UV as u64: 16-bit L1-octahedral normal xy in the low 32 bits,
  16-bit fixed-point UV in the high 32 bits
  (``librender/dequantize.glsl:23-48``),
- instance transforms as 24 bytes: f32x3 translation, f32 (signed) uniform
  scale, 4x u16 quaternion (``ext/libvkr/src/vkr.c:1346-1410``).

All codecs here are exact re-derivations of those on-disk formats, written
as vectorized numpy (the reference's scalar C loops,
``vkr.c:1223-1260``, are explicitly marked "TODO: Vectorize").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

QMASK = 0x1FFFFF  # 21 bits per axis
QMAX = float(0x1FFFFF)


# ---------------------------------------------------------------------------
# Vertex positions
# ---------------------------------------------------------------------------


def dequantize_vertices(
    vq: np.ndarray, scale: np.ndarray, offset: np.ndarray
) -> np.ndarray:
    """Render-space decode (librender/dequantize.glsl:8-21).

    vq: (N,) uint64 -> (N, 3) float32.
    """
    vq = np.asarray(vq, dtype=np.uint64)
    q = np.stack(
        [
            (vq & np.uint64(QMASK)),
            ((vq >> np.uint64(21)) & np.uint64(QMASK)),
            ((vq >> np.uint64(42)) & np.uint64(QMASK)),
        ],
        axis=-1,
    ).astype(np.float32)
    return q * np.asarray(scale, np.float32) + np.asarray(offset, np.float32)


# ---------------------------------------------------------------------------
# Normals + UV (octahedral L1 + 16-bit fixed point)
# ---------------------------------------------------------------------------


def dequantize_normal(word: np.ndarray) -> np.ndarray:
    """(N,) uint32 -> (N, 3) float32 unit normals
    (librender/dequantize.glsl:23-41). Octahedral decode with z = 1 - |x|-|y|
    and lower-hemisphere fold, then normalize."""
    word = np.asarray(word, dtype=np.uint32)
    nx = ((word & np.uint32(0xFFFF)).astype(np.int32) - 0x8000) / float(0x7FFF)
    ny = ((word >> np.uint32(16)).astype(np.int32) - 0x8000) / float(0x7FFF)
    l1 = np.abs(nx) + np.abs(ny)
    fold = l1 >= 1.0
    fx = (1.0 - np.abs(ny)) * np.where(nx >= 0.0, 1.0, -1.0)
    fy = (1.0 - np.abs(nx)) * np.where(ny >= 0.0, 1.0, -1.0)
    nx = np.where(fold, fx, nx)
    ny = np.where(fold, fy, ny)
    n = np.stack([nx, ny, 1.0 - l1], axis=-1).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return n


def dequantize_uv(word: np.ndarray) -> np.ndarray:
    """(N,) uint32 -> (N,2) float32 (librender/dequantize.glsl:43-48):
    u = qu * 8/65535, v = 1 - qv * 8/65535."""
    word = np.asarray(word, dtype=np.uint32)
    qu = (word & np.uint32(0xFFFF)).astype(np.float32)
    qv = (word >> np.uint32(16)).astype(np.float32)
    s = 8.0 / float(0xFFFF)
    return np.stack([qu * s, 1.0 - qv * s], axis=-1).astype(np.float32)


def unpack_normal_uv(nq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    nq = np.asarray(nq, dtype=np.uint64)
    n = dequantize_normal((nq & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    uv = dequantize_uv((nq >> np.uint64(32)).astype(np.uint32))
    return n, uv


# ---------------------------------------------------------------------------
# Transforms (24-byte translation + signed uniform scale + u16 quaternion)
# ---------------------------------------------------------------------------

TRANSFORM_SIZE = 24  # VKR_QUANTIZED_TRANSFORM_SIZE


def _quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """Batch quaternions (N,4) (x,y,z,w) -> rotation matrices (N,3,3)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, xy, xz, xw = x * x, x * y, x * z, x * w
    yy, yz, yw = y * y, y * z, y * w
    zz, zw = z * z, z * w
    m = np.empty((len(q), 3, 3), np.float64)
    m[:, 0, 0] = 1 - 2 * (yy + zz)
    m[:, 0, 1] = 2 * (xy - zw)
    m[:, 0, 2] = 2 * (xz + yw)
    m[:, 1, 0] = 2 * (xy + zw)
    m[:, 1, 1] = 1 - 2 * (xx + zz)
    m[:, 1, 2] = 2 * (yz - xw)
    m[:, 2, 0] = 2 * (xz - yw)
    m[:, 2, 1] = 2 * (yz + xw)
    m[:, 2, 2] = 1 - 2 * (xx + yy)
    return m


def dequantize_transforms(blob: np.ndarray) -> np.ndarray:
    """(N, 24) uint8 (or flat bytes) -> (N, 3, 4) row-major affine."""
    blob = np.asarray(blob, dtype=np.uint8).reshape(-1, TRANSFORM_SIZE)
    translation = blob[:, 0:12].copy().view("<f4").reshape(-1, 3)
    scaling = blob[:, 12:16].copy().view("<f4").reshape(-1)
    qq = blob[:, 16:24].copy().view("<u2").reshape(-1, 4)
    q = qq.astype(np.float64) * (2.0 / float(0xFFFF)) - 1.0
    q[:, 3] = -q[:, 3]
    m = _quaternion_to_matrix(q)
    # Undo the on-disk transposition back to row-major.
    m = np.swapaxes(m, 1, 2) * scaling[:, None, None]
    out = np.empty((len(blob), 3, 4), np.float32)
    out[:, :, :3] = m
    out[:, :, 3] = translation
    return out
