"""Texture container + `.vkt` reader/writer + BCn block decompression.

Equivalent of the reference's texture path: `.vkt` files (header per
``ext/libvkr/src/vkr.c:211-305``: magic 0xBC1BC1, version, mip count, w, h,
VkFormat, data size, per-mip headers) hold BC1/BC3/BC5 or RGBA8 mips; the
Vulkan backend samples them natively (``render_vulkan.cpp:1646``). TPUs have
no texture units, so textures are decompressed at load to RGBA8 mip arrays
and sampled with gather-based bilinear lookups in the shading stage.

BCn decoders are vectorized numpy over all blocks at once.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

VKT_MAGIC = 0xBC1BC1
VKT_VERSION = 1

# VkFormat-compatible enum values (ext/libvkr/src/vkr.h:51-68)
FORMAT_BC1_RGB_UNORM = 131
FORMAT_BC1_RGB_SRGB = 132
FORMAT_BC1_RGBA_UNORM = 133
FORMAT_BC1_RGBA_SRGB = 134
FORMAT_BC3_UNORM = 137
FORMAT_BC3_SRGB = 138
FORMAT_BC5_UNORM = 141
FORMAT_RGBA8_UNORM = 37

_SRGB_FORMATS = {FORMAT_BC1_RGB_SRGB, FORMAT_BC1_RGBA_SRGB, FORMAT_BC3_SRGB}
_BC1_FORMATS = {
    FORMAT_BC1_RGB_UNORM,
    FORMAT_BC1_RGB_SRGB,
    FORMAT_BC1_RGBA_UNORM,
    FORMAT_BC1_RGBA_SRGB,
}


@dataclass
class MipLevel:
    width: int
    height: int
    data: bytes  # raw block or pixel data in `format`


@dataclass
class Texture:
    """A texture with decoded RGBA8 mip chain."""

    width: int
    height: int
    format: int
    mips: List[np.ndarray] = field(default_factory=list)  # each (h, w, 4) u8
    srgb: bool = False

    @property
    def num_mips(self) -> int:
        return len(self.mips)


# ---------------------------------------------------------------------------
# BC block decoders (vectorized over blocks)
# ---------------------------------------------------------------------------


def _expand_565(c: np.ndarray):
    """(N,) uint16 -> (N,3) uint8 with standard bit replication."""
    r = ((c >> 11) & 0x1F).astype(np.uint16)
    g = ((c >> 5) & 0x3F).astype(np.uint16)
    b = (c & 0x1F).astype(np.uint16)
    r = ((r << 3) | (r >> 2)).astype(np.uint8)
    g = ((g << 2) | (g >> 4)).astype(np.uint8)
    b = ((b << 3) | (b >> 2)).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def decode_bc1(data: bytes, width: int, height: int, opaque: bool) -> np.ndarray:
    """BC1 (DXT1) -> (height, width, 4) uint8."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    blocks = np.frombuffer(data, dtype="<u4").reshape(bw * bh, 2)
    c01 = blocks[:, 0]
    c0 = (c01 & 0xFFFF).astype(np.uint16)
    c1 = (c01 >> 16).astype(np.uint16)
    idx = blocks[:, 1]

    p0 = _expand_565(c0).astype(np.int32)
    p1 = _expand_565(c1).astype(np.int32)
    four_color = c0 > c1

    # palette: (N, 4, 4) rgba
    pal = np.zeros((len(blocks), 4, 4), np.int32)
    pal[:, 0, :3] = p0
    pal[:, 1, :3] = p1
    pal[:, 0, 3] = 255
    pal[:, 1, 3] = 255
    # four-color mode: 2/3, 1/3 blends; three-color: 1/2 blend + transparent
    blend2 = (2 * p0 + p1 + 1) // 3
    blend3 = (p0 + 2 * p1 + 1) // 3
    half = (p0 + p1) // 2
    pal[:, 2, :3] = np.where(four_color[:, None], blend2, half)
    pal[:, 2, 3] = 255
    pal[:, 3, :3] = np.where(four_color[:, None], blend3, 0)
    # 3-color mode index 3: transparent black for RGBA formats, opaque black
    # for the punch-through-less RGB formats.
    pal[:, 3, 3] = np.where(four_color, 255, 255 if opaque else 0)

    # per-texel 2-bit indices
    shifts = np.arange(16, dtype=np.uint32) * 2
    sel = ((idx[:, None] >> shifts[None, :]) & 3).astype(np.int32)  # (N,16)
    texels = np.take_along_axis(
        pal, sel[:, :, None].repeat(4, axis=2), axis=1
    )  # (N,16,4)
    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)[:height, :width]
    return img.astype(np.uint8)


def _decode_bc_alpha(block_lo: np.ndarray, block_hi: np.ndarray) -> np.ndarray:
    """BC4-style 3-bit interpolated single channel.

    block_lo/hi: (N,) uint32 pairs forming the 8-byte alpha block.
    Returns (N, 16) uint8.
    """
    a0 = (block_lo & 0xFF).astype(np.int32)
    a1 = ((block_lo >> 8) & 0xFF).astype(np.int32)
    # 48 bits of indices spread over the two words
    bits = (block_lo.astype(np.uint64) >> np.uint64(16)) | (
        block_hi.astype(np.uint64) << np.uint64(16)
    )
    shifts = (np.arange(16, dtype=np.uint64)) * np.uint64(3)
    sel = ((bits[:, None] >> shifts[None, :]) & np.uint64(7)).astype(np.int32)

    # palettes for both modes (N, 8)
    k = np.arange(8)
    pal8 = np.where(
        k[None, :] == 0,
        a0[:, None],
        np.where(
            k[None, :] == 1,
            a1[:, None],
            ((8 - k[None, :]) * a0[:, None] + (k[None, :] - 1) * a1[:, None]) // 7,
        ),
    )
    pal6 = np.where(
        k[None, :] == 0,
        a0[:, None],
        np.where(
            k[None, :] == 1,
            a1[:, None],
            np.where(
                k[None, :] == 6,
                0,
                np.where(
                    k[None, :] == 7,
                    255,
                    ((6 - k[None, :]) * a0[:, None] + (k[None, :] - 1) * a1[:, None])
                    // 5,
                ),
            ),
        ),
    )
    pal = np.where((a0 > a1)[:, None], pal8, pal6)
    return np.take_along_axis(pal, sel, axis=1).astype(np.uint8)


def decode_bc3(data: bytes, width: int, height: int) -> np.ndarray:
    """BC3 (DXT5) -> (height, width, 4) uint8."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    raw = np.frombuffer(data, dtype="<u4").reshape(bw * bh, 4)
    alpha = _decode_bc_alpha(raw[:, 0], raw[:, 1])  # (N,16)
    color = decode_bc1(
        np.ascontiguousarray(raw[:, 2:4]).tobytes(), bw * 4, bh * 4, opaque=True
    )
    # bc1 part of bc3 always decodes in 4-color mode regardless of c0<=c1;
    # stb-style decoders do the same since encoders avoid 3-color here.
    a_img = alpha.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)
    color[:, :, 3] = a_img
    return color[:height, :width]


def decode_bc5(data: bytes, width: int, height: int) -> np.ndarray:
    """BC5 (2x BC4) -> (height, width, 4) uint8: RG decoded, B=0, A=255."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    raw = np.frombuffer(data, dtype="<u4").reshape(bw * bh, 4)
    r = _decode_bc_alpha(raw[:, 0], raw[:, 1])
    g = _decode_bc_alpha(raw[:, 2], raw[:, 3])

    def to_img(ch):
        return ch.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)

    out = np.zeros((bh * 4, bw * 4, 4), np.uint8)
    out[:, :, 0] = to_img(r)
    out[:, :, 1] = to_img(g)
    out[:, :, 3] = 255
    return out[:height, :width]


def decode_mip(fmt: int, data: bytes, width: int, height: int) -> np.ndarray:
    from realtimepathtracingresearchframework_tpu_torch import native

    if fmt in _BC1_FORMATS:
        out = native.decode_bc1(data, width, height, fmt in (131, 132))
        return out if out is not None else decode_bc1(
            data, width, height, opaque=fmt in (131, 132)
        )
    if fmt in (FORMAT_BC3_UNORM, FORMAT_BC3_SRGB):
        out = native.decode_bc3(data, width, height)
        return out if out is not None else decode_bc3(data, width, height)
    if fmt == FORMAT_BC5_UNORM:
        out = native.decode_bc5(data, width, height)
        return out if out is not None else decode_bc5(data, width, height)
    if fmt == FORMAT_RGBA8_UNORM:
        return (
            np.frombuffer(data, np.uint8)
            .reshape(height, width, 4)
            .copy()
        )
    raise ValueError(f"unsupported texture format {fmt}")


# ---------------------------------------------------------------------------
# .vkt file IO
# ---------------------------------------------------------------------------


def read_vkt(path: str) -> Texture:
    with open(path, "rb") as f:
        data = f.read()
    magic, version, num_mips, width, height, fmt = struct.unpack_from(
        "<iiiiii", data, 0
    )
    if magic != VKT_MAGIC:
        raise ValueError(f"{path}: not a .vkt file")
    if version != VKT_VERSION:
        raise ValueError(f"{path}: unsupported .vkt version {version}")
    (data_size,) = struct.unpack_from("<Q", data, 24)
    pos = 32
    mips_meta = []
    for _ in range(num_mips):
        mw, mh = struct.unpack_from("<ii", data, pos)
        msize, moff = struct.unpack_from("<Qq", data, pos + 8)
        mips_meta.append((mw, mh, msize, moff))
        pos += 24
    data_offset = pos
    tex = Texture(width, height, fmt, srgb=fmt in _SRGB_FORMATS)
    for mw, mh, msize, moff in mips_meta:
        raw = data[data_offset + moff : data_offset + moff + msize]
        tex.mips.append(decode_mip(fmt, raw, mw, mh))
    return tex


def _encode_mip_rgba8(img: np.ndarray) -> bytes:
    return np.ascontiguousarray(img, dtype=np.uint8).tobytes()


def build_mip_chain(img: np.ndarray) -> List[np.ndarray]:
    """Box-filter mip chain; dimensions must be powers of two (the reference
    converter upsamples to pow2 first, vkr.h:441-443)."""
    mips = [np.asarray(img, np.uint8)]
    while mips[-1].shape[0] > 1 or mips[-1].shape[1] > 1:
        cur = mips[-1].astype(np.uint16)
        h, w = cur.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        if h > 1 and w > 1:
            nxt = (
                cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2] + 2
            ) // 4
        elif h > 1:
            nxt = (cur[0::2] + cur[1::2] + 1) // 2
        else:
            nxt = (cur[:, 0::2] + cur[:, 1::2] + 1) // 2
        mips.append(nxt.astype(np.uint8))
    return mips


def write_vkt(path: str, img: np.ndarray, srgb: bool = False) -> None:
    """Write an RGBA8 .vkt with a full mip chain (format 37).

    The reference converter also emits BC1/BC5 (vkr.h:453-456); RGBA8 is a
    first-class format in the spec and what our exporter uses.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] < 4:
        pad = np.full((*img.shape[:2], 4 - img.shape[2]), 255, np.uint8)
        img = np.concatenate([img, pad], axis=2)
    h, w = img.shape[:2]
    if (h & (h - 1)) or (w & (w - 1)):
        raise ValueError("write_vkt requires power-of-two dimensions")
    mips = build_mip_chain(img)
    payloads = [_encode_mip_rgba8(m) for m in mips]
    total = sum(len(p) for p in payloads)
    with open(path, "wb") as f:
        f.write(
            struct.pack(
                "<iiiiii", VKT_MAGIC, VKT_VERSION, len(mips), w, h, FORMAT_RGBA8_UNORM
            )
        )
        f.write(struct.pack("<Q", total))
        off = 0
        for m, p in zip(mips, payloads):
            f.write(struct.pack("<iiQq", m.shape[1], m.shape[0], len(p), off))
            off += len(p)
        for p in payloads:
            f.write(p)


def sample_bilinear(mip: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Host-side bilinear sample for testing: mip (h,w,4) u8, uv (N,2) in [0,1),
    wrap addressing. Returns (N,4) float in [0,1]."""
    h, w = mip.shape[:2]
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0w, x1w = x0 % w, (x0 + 1) % w
    y0w, y1w = y0 % h, (y0 + 1) % h
    p00 = mip[y0w, x0w].astype(np.float32)
    p10 = mip[y0w, x1w].astype(np.float32)
    p01 = mip[y1w, x0w].astype(np.float32)
    p11 = mip[y1w, x1w].astype(np.float32)
    out = (
        p00 * (1 - fx) * (1 - fy)
        + p10 * fx * (1 - fy)
        + p01 * (1 - fx) * fy
        + p11 * fx * fy
    )
    return out / 255.0
