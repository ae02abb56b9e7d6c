"""Image readers/writers: PFM, EXR, PNG.

Equivalent of ``util/write_image.{h,cpp}`` (PNG/PFM/EXR writers via
stb/tinyexr) plus readers for our own outputs (needed by the compare tool,
``util/compare_exr.cpp``). Pure Python/numpy — no external image deps.

Conventions match the reference:
- PFM: ``PF\\n<w> <h>\\n-1.0\\n`` header, little-endian f32 RGB, scanlines
  stored bottom-up (write_image.cpp:51-63).
- EXR: scanline images, channels stored as separate planes sorted by name
  (A,B,G,R); we write ZIP-compressed or uncompressed fp32/fp16.
- PNG: 8-bit RGB(A), zlib.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Tuple

import numpy as np


def _open_out(path) -> "object":
    """Open for binary write, creating parent directories as needed."""
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    return open(path, "wb")


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------


def write_pfm(path: str, pixels: np.ndarray) -> None:
    """pixels: (H, W, C>=3) float array; writes first 3 channels."""
    if not str(path).endswith(".pfm"):
        path = str(path) + ".pfm"
    pixels = np.asarray(pixels, dtype=np.float32)
    if pixels.ndim != 3 or pixels.shape[2] < 3:
        raise ValueError("write_pfm expects (H, W, >=3)")
    h, w = pixels.shape[:2]
    rgb = pixels[::-1, :, :3].astype("<f4")  # bottom-up scanlines
    with _open_out(path) as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(rgb.tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        channels = 3 if magic == b"PF" else 1
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(4 * w * h * channels), dtype=dtype)
    img = data.reshape(h, w, channels)[::-1]  # back to top-down
    return np.ascontiguousarray(img.astype(np.float32))


# ---------------------------------------------------------------------------
# EXR (scanline, fp16/fp32, NONE or ZIP compression)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PT_HALF = 1
_PT_FLOAT = 2
_COMPRESSION_NONE = 0
_COMPRESSION_ZIP = 3  # zlib, blocks of 16 scanlines
_COMPRESSION_PIZ = 4  # wavelet + Huffman, blocks of 32 scanlines

EXR_COMPRESSION_NONE = "none"
EXR_COMPRESSION_ZIP = "zip"
EXR_COMPRESSION_PIZ = "piz"  # what the reference binary writes for
# validation images (libapp/app_state.cpp:467-481) — utils/exr_piz.py


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def _zip_reorder(data: bytes) -> bytes:
    """EXR ZIP preprocessing, OpenEXR's ImfZip order: SPLIT the bytes
    into even/odd halves first, THEN delta-encode the split stream.
    (Predict-then-split produces files standard loaders decode to
    garbage — the two steps do not commute.)"""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    split = np.empty(n, dtype=np.uint8)
    split[:half] = arr[0::2]
    split[half:] = arr[1::2]
    d = split.astype(np.int16)
    out = np.empty_like(d)
    out[0] = d[0]
    out[1:] = d[1:] - d[:-1] + 128 + 256
    return out.astype(np.uint8).tobytes()


def _zip_unreorder(data: bytes) -> bytes:
    """Inverse of ``_zip_reorder``: predictor-undo, then interleave."""
    d = np.frombuffer(data, dtype=np.uint8).astype(np.int16).copy()
    d[1:] -= 128 + 256
    split = np.cumsum(d, dtype=np.int64).astype(np.uint8)
    n = len(split)
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    out[0::2] = split[:half]
    out[1::2] = split[half:]
    return out.tobytes()


def write_exr(
    path: str,
    channels: Dict[str, np.ndarray],
    half: bool = True,
    compression: str = EXR_COMPRESSION_ZIP,
) -> None:
    """channels: name -> (H, W) float array. All shapes must match."""
    if not str(path).endswith(".exr"):
        path = str(path) + ".exr"
    names = sorted(channels.keys())  # EXR requires alphabetical channel order
    h, w = next(iter(channels.values())).shape
    pt = _PT_HALF if half else _PT_FLOAT
    np_dtype = "<f2" if half else "<f4"
    comp = {
        EXR_COMPRESSION_ZIP: _COMPRESSION_ZIP,
        EXR_COMPRESSION_PIZ: _COMPRESSION_PIZ,
    }.get(compression, _COMPRESSION_NONE)
    lines_per_block = {
        _COMPRESSION_ZIP: 16, _COMPRESSION_PIZ: 32
    }.get(comp, 1)

    chan_list = b""
    for name in names:
        chan_list += (
            name.encode() + b"\0" + struct.pack("<iiii", pt, 0, 1, 1)
        )
    chan_list += b"\0"

    header = b""
    header += _exr_attr(b"channels", b"chlist", chan_list)
    header += _exr_attr(b"compression", b"compression", struct.pack("<B", comp))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\0")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    planes = {n: np.asarray(channels[n]).astype(np_dtype) for n in names}

    blocks = []
    y = 0
    while y < h:
        ny = min(lines_per_block, h - y)
        raw = b"".join(
            planes[n][y + dy].tobytes() for dy in range(ny) for n in names
        )
        if comp == _COMPRESSION_ZIP:
            packed = zlib.compress(_zip_reorder(raw))
            if len(packed) >= len(raw):
                packed = raw
        elif comp == _COMPRESSION_PIZ:
            from realtimepathtracingresearchframework_tpu_torch.utils import exr_piz

            bpp = 2 if half else 4
            packed = exr_piz.piz_compress(
                raw, w, ny, [(n, bpp) for n in names]
            )
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        blocks.append((y, packed))
        y += ny

    with _open_out(path) as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        offset_table_pos = f.tell()
        f.write(b"\0" * 8 * len(blocks))
        offsets = []
        for y0, packed in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(packed)))
            f.write(packed)
        f.seek(offset_table_pos)
        f.write(struct.pack("<%dQ" % len(offsets), *offsets))


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Reads scanline EXR written by us (NONE or ZIP); returns name->(H,W) f32."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        nul = data.index(b"\0", pos)
        name = data[pos:nul].decode()
        pos = nul + 1
        nul = data.index(b"\0", pos)
        typ = data[pos:nul].decode()
        pos = nul + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos : pos + size])
        pos += size
    pos += 1  # header terminator

    chan_data = attrs["channels"][1]
    channels = []
    cp = 0
    while chan_data[cp] != 0:
        nul = chan_data.index(b"\0", cp)
        cname = chan_data[cp:nul].decode()
        pt, _, _, _ = struct.unpack_from("<iiii", chan_data, nul + 1)
        channels.append((cname, pt))
        cp = nul + 1 + 16
    (comp,) = struct.unpack_from("<B", attrs["compression"][1], 0)
    x0, y0, x1, y1 = struct.unpack_from("<iiii", attrs["dataWindow"][1], 0)
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines_per_block = {
        _COMPRESSION_NONE: 1, _COMPRESSION_ZIP: 16, _COMPRESSION_PIZ: 32
    }.get(comp)
    if lines_per_block is None:
        raise ValueError(f"{path}: unsupported EXR compression {comp}")

    nblocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from("<%dQ" % nblocks, data, pos)

    out = {n: np.empty((h, w), np.float32) for n, _ in channels}
    bytes_per_px = {_PT_HALF: 2, _PT_FLOAT: 4}
    for off in offsets:
        by, size = struct.unpack_from("<ii", data, off)
        payload = data[off + 8 : off + 8 + size]
        by -= y0  # block y is absolute in the dataWindow, rows are 0-based
        ny = min(lines_per_block, h - by)
        raw_size = ny * w * sum(bytes_per_px[pt] for _, pt in channels)
        if comp == _COMPRESSION_ZIP and size < raw_size:
            raw = _zip_unreorder(zlib.decompress(payload))
        elif comp == _COMPRESSION_PIZ and size < raw_size:
            from realtimepathtracingresearchframework_tpu_torch.utils import exr_piz

            raw = exr_piz.piz_uncompress(
                payload, w, ny,
                [(n, bytes_per_px[pt]) for n, pt in channels],
            )
        else:
            raw = payload
        rp = 0
        for dy in range(ny):
            for cname, pt in channels:
                nbytes = w * bytes_per_px[pt]
                dt = "<f2" if pt == _PT_HALF else "<f4"
                row = np.frombuffer(raw[rp : rp + nbytes], dtype=dt)
                out[cname][by + dy] = row.astype(np.float32)
                rp += nbytes
    return out


def write_exr_rgba(
    path: str, pixels: np.ndarray, half: bool = True, compression: str = EXR_COMPRESSION_ZIP
) -> None:
    """pixels: (H, W, 3|4) float."""
    chans = {"R": pixels[..., 0], "G": pixels[..., 1], "B": pixels[..., 2]}
    if pixels.shape[-1] >= 4:
        chans["A"] = pixels[..., 3]
    write_exr(path, chans, half=half, compression=compression)


def read_exr_rgba(path: str) -> np.ndarray:
    chans = read_exr(path)
    names = [n for n in ("R", "G", "B", "A") if n in chans]
    if not names:
        names = sorted(chans.keys())
    return np.stack([chans[n] for n in names], axis=-1)


# ---------------------------------------------------------------------------
# PNG (8-bit, minimal encoder/decoder)
# ---------------------------------------------------------------------------


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(pixels: np.ndarray, compress_level: int = 6) -> bytes:
    """(H, W, 1|3|4) uint8 or float in [0,1] -> PNG bytes in memory.

    One encoder for both disk writes (write_png) and the interactive
    viewer's frame streaming (app/viewer.py), which passes
    compress_level=1 for latency."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8:
        px = np.clip(np.round(px * 255.0), 0, 255).astype(np.uint8)
    h, w, c = px.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\0" + px[y].tobytes() for y in range(h))
    return b"".join((
        b"\x89PNG\r\n\x1a\n",
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)),
        _png_chunk(b"IDAT", zlib.compress(raw, compress_level)),
        _png_chunk(b"IEND", b""),
    ))


def write_png(path: str, pixels: np.ndarray) -> None:
    """pixels: (H, W, 3|4) uint8 or float in [0,1]."""
    if not str(path).endswith(".png"):
        path = str(path) + ".png"
    with _open_out(path) as f:
        f.write(encode_png(pixels))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if bitdepth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNG supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    nchan = {0: 1, 2: 3, 6: 4}.get(color_type)
    if nchan is None:
        raise ValueError(
            f"unsupported PNG color type {color_type} (palette/gray+alpha)"
        )
    raw = zlib.decompress(idat)
    stride = w * nchan
    img = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    rp = 0
    for y in range(h):
        ftype = raw[rp]
        row = np.frombuffer(raw[rp + 1 : rp + 1 + stride], np.uint8).astype(np.int32)
        rp += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 1:  # Sub
            cur = row.copy()
            for i in range(nchan, stride):
                cur[i] = (cur[i] + cur[i - nchan]) & 0xFF
        elif ftype == 2:  # Up
            cur = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = row.copy()
            for i in range(stride):
                left = cur[i - nchan] if i >= nchan else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = row.copy()
            for i in range(stride):
                a = cur[i - nchan] if i >= nchan else 0
                b = prev[i]
                cc = prev[i - nchan] if i >= nchan else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        img[y] = cur.astype(np.uint8)
        prev = cur
    return img.reshape(h, w, nchan)
