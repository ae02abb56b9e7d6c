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

    vq: (N,) uint64 -> (N, 3) float32. Uses the native C++ decoder when
    built (native/vkr_decode.cpp); numpy otherwise.
    """
    from realtimepathtracingresearchframework_tpu_torch import native

    out = native.dequantize_vertices(vq, scale, offset)
    if out is not None:
        return out
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


def quantize_vertices(
    v: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize float32 (N,3) positions into u64 + (scale, offset).

    Chooses per-axis scale/offset from the AABB so decode via
    :func:`dequantize_vertices` reproduces positions to ~extent/2^21.
    """
    v = np.asarray(v, dtype=np.float32)
    vmin = v.min(axis=0)
    vmax = v.max(axis=0)
    extent = np.maximum(vmax - vmin, 1e-12)
    scale = (extent / QMAX).astype(np.float32)
    offset = vmin.astype(np.float32)
    q = np.clip(np.rint((v - offset) / scale), 0, QMAX).astype(np.uint64)
    vq = q[:, 0] | (q[:, 1] << np.uint64(21)) | (q[:, 2] << np.uint64(42))
    return vq, scale, offset


def dequantize_vertices_libvkr(
    vq: np.ndarray, scale: np.ndarray, offset: np.ndarray
) -> np.ndarray:
    """libvkr CPU-convention decode with Y/Z swizzle + X negation
    (ext/libvkr/src/vkr.c:1223-1235) — used by vkr2obj-style tooling."""
    vq = np.asarray(vq, dtype=np.uint64)
    x = (vq & np.uint64(QMASK)).astype(np.float32)
    z = ((vq >> np.uint64(21)) & np.uint64(QMASK)).astype(np.float32)
    y = ((vq >> np.uint64(42)) & np.uint64(QMASK)).astype(np.float32)
    scale = np.asarray(scale, np.float32)
    offset = np.asarray(offset, np.float32)
    out = np.empty((len(vq), 3), np.float32)
    out[:, 0] = x * (-scale[0]) - offset[0]
    out[:, 1] = y * scale[2] + offset[2]
    out[:, 2] = z * scale[1] + offset[1]
    return out


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


def quantize_normal(n: np.ndarray) -> np.ndarray:
    """(N,3) float unit normals -> (N,) uint32 via L1-octahedral mapping."""
    n = np.asarray(n, dtype=np.float64)
    n = n / np.maximum(np.abs(n).sum(axis=-1, keepdims=True), 1e-20)
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    # Lower hemisphere: fold onto the outer triangles.
    fx = (1.0 - np.abs(y)) * np.where(x >= 0.0, 1.0, -1.0)
    fy = (1.0 - np.abs(x)) * np.where(y >= 0.0, 1.0, -1.0)
    ox = np.where(z < 0.0, fx, x)
    oy = np.where(z < 0.0, fy, y)
    qx = np.clip(np.rint(ox * 0x7FFF) + 0x8000, 0, 0xFFFF).astype(np.uint32)
    qy = np.clip(np.rint(oy * 0x7FFF) + 0x8000, 0, 0xFFFF).astype(np.uint32)
    return qx | (qy << np.uint32(16))


def dequantize_uv(word: np.ndarray) -> np.ndarray:
    """(N,) uint32 -> (N,2) float32 (librender/dequantize.glsl:43-48):
    u = qu * 8/65535, v = 1 - qv * 8/65535."""
    word = np.asarray(word, dtype=np.uint32)
    qu = (word & np.uint32(0xFFFF)).astype(np.float32)
    qv = (word >> np.uint32(16)).astype(np.float32)
    s = 8.0 / float(0xFFFF)
    return np.stack([qu * s, 1.0 - qv * s], axis=-1).astype(np.float32)


def quantize_uv(uv: np.ndarray) -> np.ndarray:
    """(N,2) float -> (N,) uint32; UVs must lie in the codec's range
    (u in [0,8], v in [1-8, 1]); callers wrap texture coordinates."""
    uv = np.asarray(uv, dtype=np.float64)
    s = float(0xFFFF) / 8.0
    qu = np.clip(np.rint(uv[:, 0] * s), 0, 0xFFFF).astype(np.uint32)
    qv = np.clip(np.rint((1.0 - uv[:, 1]) * s), 0, 0xFFFF).astype(np.uint32)
    return qu | (qv << np.uint32(16))


def pack_normal_uv(n: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """(N,3)+(N,2) -> (N,) uint64: normal low 32 bits, uv high 32 bits."""
    return quantize_normal(n).astype(np.uint64) | (
        quantize_uv(uv).astype(np.uint64) << np.uint64(32)
    )


def unpack_normal_uv(nq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from realtimepathtracingresearchframework_tpu_torch import native

    out = native.dequantize_normal_uv(nq)
    if out is not None:
        return out
    nq = np.asarray(nq, dtype=np.uint64)
    n = dequantize_normal((nq & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    uv = dequantize_uv((nq >> np.uint64(32)).astype(np.uint32))
    return n, uv


# ---------------------------------------------------------------------------
# Transforms (24-byte translation + signed uniform scale + u16 quaternion)
# ---------------------------------------------------------------------------

TRANSFORM_SIZE = 24  # VKR_QUANTIZED_TRANSFORM_SIZE


def _matrix_to_quaternion(m: np.ndarray) -> np.ndarray:
    """Batch rotation matrices (N,3,3) -> quaternions (N,4) (x,y,z,w);
    branch selection per vkr.c:1265-1310."""
    m = np.asarray(m, dtype=np.float64)
    n = m.shape[0]
    q = np.empty((n, 4), np.float64)
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]

    c0 = tr > 0.1
    c1 = (~c0) & (m[:, 0, 0] > m[:, 1, 1]) & (m[:, 0, 0] > m[:, 2, 2])
    c2 = (~c0) & (~c1) & (m[:, 1, 1] > m[:, 0, 0]) & (m[:, 1, 1] > m[:, 2, 2])
    c3 = ~(c0 | c1 | c2)

    q[c0] = np.stack(
        [
            m[c0, 2, 1] - m[c0, 1, 2],
            m[c0, 0, 2] - m[c0, 2, 0],
            m[c0, 1, 0] - m[c0, 0, 1],
            1.0 + tr[c0],
        ],
        axis=-1,
    )
    q[c1] = np.stack(
        [
            1.0 + m[c1, 0, 0] - m[c1, 1, 1] - m[c1, 2, 2],
            m[c1, 1, 0] + m[c1, 0, 1],
            m[c1, 0, 2] + m[c1, 2, 0],
            m[c1, 2, 1] - m[c1, 1, 2],
        ],
        axis=-1,
    )
    q[c2] = np.stack(
        [
            m[c2, 1, 0] + m[c2, 0, 1],
            1.0 + m[c2, 1, 1] - m[c2, 0, 0] - m[c2, 2, 2],
            m[c2, 2, 1] + m[c2, 1, 2],
            m[c2, 0, 2] - m[c2, 2, 0],
        ],
        axis=-1,
    )
    q[c3] = np.stack(
        [
            m[c3, 0, 2] + m[c3, 2, 0],
            m[c3, 2, 1] + m[c3, 1, 2],
            1.0 + m[c3, 2, 2] - m[c3, 0, 0] - m[c3, 1, 1],
            m[c3, 1, 0] - m[c3, 0, 1],
        ],
        axis=-1,
    )
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


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


def quantize_transforms(matrices: np.ndarray) -> np.ndarray:
    """(N, 3, 4) row-major affine transforms -> (N, 24) uint8.

    Only similarity transforms (rotation x uniform scale + translation,
    possibly orientation-reversing) survive quantization — same contract as
    ``vkr_quantize_transform`` ("matrix without shear", vkr.c:1346-1378).
    The on-disk convention stores the TRANSPOSED linear part's quaternion
    with flipped w; this function accepts standard row-major (3,4).
    """
    matrices = np.asarray(matrices, dtype=np.float64)
    linear = matrices[:, :, :3]
    translation = matrices[:, :, 3].astype(np.float32)
    # signed uniform scale: norm of first *column* of the transposed matrix
    # = norm of first row of `linear.T` = norm of linear[:,:,0]... The
    # reference measures the first row of its column-major storage, which is
    # the first column of the row-major matrix.
    scaling = np.linalg.norm(linear[:, :, 0], axis=-1)
    det = np.linalg.det(linear)
    scaling = np.where(det < 0.0, -scaling, scaling)
    normed = linear / scaling[:, None, None]
    # The file stores the quaternion of the transposed linear part with
    # negated w; quaternion(M^T) == conjugate(quaternion(M)), and negating w
    # of the conjugate recovers (-x,-y,-z,w) ~ same rotation — we reproduce
    # the exact byte stream by transposing before extraction.
    q = _matrix_to_quaternion(np.swapaxes(normed, 1, 2))
    q[:, 3] = -q[:, 3]
    qq = np.clip(
        np.floor((q * 0.5 + 0.5) * float(0xFFFF) - 0.5), 0, 0xFFFF
    ).astype(np.uint16)

    out = np.empty((len(matrices), TRANSFORM_SIZE), np.uint8)
    out[:, 0:12] = translation.astype("<f4").view(np.uint8).reshape(-1, 12)
    out[:, 12:16] = (
        scaling.astype("<f4").view(np.uint8).reshape(-1, 4)
    )
    out[:, 16:24] = qq.astype("<u2").view(np.uint8).reshape(-1, 8)
    return out


def dequantize_transforms(blob: np.ndarray) -> np.ndarray:
    """(N, 24) uint8 (or flat bytes) -> (N, 3, 4) row-major affine."""
    from realtimepathtracingresearchframework_tpu_torch import native

    out = native.dequantize_transforms(np.asarray(blob, np.uint8))
    if out is not None:
        return out
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
