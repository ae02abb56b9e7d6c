"""PIZ (wavelet + Huffman) codec for OpenEXR scanline blocks.

The reference writes its validation images PIZ-compressed
(``libapp/app_state.cpp:467-481`` selects EXR_COMPRESSION_PIZ,
``util/write_image.cpp:150-151`` maps it to tinyexr) and its
``compare_exr`` tool consumes them (``util/compare_exr.cpp:51-132``) —
so images produced by the *reference binary* are PIZ files. This module
implements the PIZ scheme from the OpenEXR 2.x file-format specification
so ``utils/image_io.read_exr`` / ``utils/compare.py`` can read them (and
``write_exr`` can produce byte-compatible ones):

- a 16-bit-value presence bitmap + look-up table (ImfPizCompressor),
- a 2-D 16-bit integer wavelet per channel plane (ImfWav: wdec14/wdec16
  modular transforms),
- canonical Huffman coding with 6-bit code-length table and an explicit
  run-length pseudo-symbol (ImfHuf).

A PIZ chunk covers up to 32 scanlines. Layout:

    u16 minNonZero, u16 maxNonZero,
    bitmap[minNonZero..maxNonZero]            (present iff min <= max),
    i32 huffman byte length,
    huffman stream: u32 im, u32 iM, u32 tableLen(informational),
                    u32 nBits, u32 zero, packed code-length table,
                    MSB-first data bits.

Channel data inside the chunk is channel-major (each channel's
``nx * ny * size`` u16s contiguous, ``size`` = shorts per pixel: HALF=1,
FLOAT/UINT=2); the decoded chunk is reassembled scanline-major exactly
like a ZIP/NONE chunk. Pure numpy + Python — no external deps.
"""

from __future__ import annotations

import heapq
import struct
from typing import List, Tuple

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3

HUF_ENCBITS = 16
HUF_DECBITS = 14
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1  # 65537 (one run-length pseudo-symbol)
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN

PIZ_LINES_PER_BLOCK = 32

_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_M_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


# ---------------------------------------------------------------------------
# bitmap / LUT (ImfPizCompressor bitmapFromData & friends)
# ---------------------------------------------------------------------------


def _bitmap_from_data(data: np.ndarray):
    present = np.zeros(USHORT_RANGE, bool)
    present[data] = True
    present[0] = False  # zero is not stored in the bitmap
    bitmap = np.packbits(present, bitorder="little")
    nz = np.nonzero(bitmap)[0]
    if len(nz) == 0:
        return bitmap, BITMAP_SIZE - 1, 0  # min > max: all-zero bitmap
    return bitmap, int(nz[0]), int(nz[-1])


def _forward_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little")
    used = bits.astype(bool)
    used[0] = True
    lut = np.zeros(USHORT_RANGE, np.uint16)
    idx = np.nonzero(used)[0]
    lut[idx] = np.arange(len(idx), dtype=np.uint16)
    return lut, len(idx) - 1  # maxValue


def _reverse_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little")
    used = bits.astype(bool)
    used[0] = True
    idx = np.nonzero(used)[0]
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[: len(idx)] = idx.astype(np.uint16)
    return lut, len(idx) - 1  # maxValue


# ---------------------------------------------------------------------------
# 2-D wavelet (ImfWav.cpp), vectorized per level
# ---------------------------------------------------------------------------


def _wdec14(lo, hi):
    ls = lo.astype(np.int16).astype(np.int32)
    hs = hi.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc14(a, b):
    a_s = a.astype(np.int16).astype(np.int32)
    b_s = b.astype(np.int16).astype(np.int32)
    ms = (a_s + b_s) >> 1
    ds = a_s - b_s
    return ms.astype(np.int16).astype(np.uint16), ds.astype(np.int16).astype(
        np.uint16
    )


def _wdec16(lo, hi):
    m = lo.astype(np.int32)
    d = hi.astype(np.int32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    m = (ao + b.astype(np.int32)) >> 1
    d = ao - b.astype(np.int32)
    m = np.where(d < 0, (m + _M_OFFSET) & _MOD_MASK, m)
    d = d & _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def wav2_decode(plane: np.ndarray, mx: int) -> None:
    """In-place 2-D wavelet decode of a (ny, nx) u16 plane (wav2Decode)."""
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    ny, nx = plane.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        yy = ys[:, None]
        xx = xs[None, :]
        a00 = plane[yy, xx]
        a01 = plane[yy, xx + p]
        a10 = plane[yy + p, xx]
        a11 = plane[yy + p, xx + p]
        i00, i10 = dec(a00, a10)
        i01, i11 = dec(a01, a11)
        r00, r01 = dec(i00, i01)
        r10, r11 = dec(i10, i11)
        plane[yy, xx] = r00
        plane[yy, xx + p] = r01
        plane[yy + p, xx] = r10
        plane[yy + p, xx + p] = r11
        if nx & p:
            x = len(xs) * p2
            a, b = dec(plane[ys, x], plane[ys + p, x])
            plane[ys, x] = a
            plane[ys + p, x] = b
        if ny & p:
            y = len(ys) * p2
            a, b = dec(plane[y, xs], plane[y, xs + p])
            plane[y, xs] = a
            plane[y, xs + p] = b
        p2 = p
        p >>= 1


def wav2_encode(plane: np.ndarray, mx: int) -> None:
    """In-place 2-D wavelet encode of a (ny, nx) u16 plane (wav2Encode)."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    ny, nx = plane.shape
    n = min(nx, ny)
    p = 1
    p2 = 2
    while p2 <= n:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        yy = ys[:, None]
        xx = xs[None, :]
        a00 = plane[yy, xx]
        a01 = plane[yy, xx + p]
        a10 = plane[yy + p, xx]
        a11 = plane[yy + p, xx + p]
        i00, i01 = enc(a00, a01)
        i10, i11 = enc(a10, a11)
        r00, r10 = enc(i00, i10)
        r01, r11 = enc(i01, i11)
        plane[yy, xx] = r00
        plane[yy, xx + p] = r01
        plane[yy + p, xx] = r10
        plane[yy + p, xx + p] = r11
        if nx & p:
            x = len(xs) * p2
            a, b = enc(plane[ys, x], plane[ys + p, x])
            plane[ys, x] = a
            plane[ys + p, x] = b
        if ny & p:
            y = len(ys) * p2
            a, b = enc(plane[y, xs], plane[y, xs + p])
            plane[y, xs] = a
            plane[y, xs + p] = b
        p = p2
        p2 <<= 1


# ---------------------------------------------------------------------------
# Huffman coding (ImfHuf.cpp)
# ---------------------------------------------------------------------------


def _huf_canonical_code_table(lengths: np.ndarray) -> np.ndarray:
    """lengths (HUF_ENCSIZE,) -> packed (code << 6 | length) table
    (hufCanonicalCodeTable)."""
    n = np.zeros(59, np.uint64)
    cnt = np.bincount(lengths, minlength=59)
    n[: len(cnt[:59])] = cnt[:59]
    c = np.uint64(0)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> np.uint64(1)
        n[i] = c
        c = nc
    hcode = np.zeros(HUF_ENCSIZE, np.uint64)
    for i in np.nonzero(lengths)[0]:
        l = int(lengths[i])
        hcode[i] = np.uint64(l) | (n[l] << np.uint64(6))
        n[l] += np.uint64(1)
    return hcode


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, nbits: int, bits: int) -> None:
        self.c = (self.c << nbits) | (bits & ((1 << nbits) - 1))
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)
        self.c &= (1 << self.lc) - 1

    def bit_count(self) -> int:
        return len(self.out) * 8 + self.lc

    def flush(self) -> bytes:
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.c = 0
            self.lc = 0
        return bytes(self.out)


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get_bits(self, nbits: int) -> int:
        while self.lc < nbits:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= nbits
        return (self.c >> self.lc) & ((1 << nbits) - 1)


def _huf_pack_enc_table(hcode: np.ndarray, im: int, iM: int) -> bytes:
    w = _BitWriter()
    i = im
    lengths = (hcode & np.uint64(63)).astype(np.int64)
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            zerun = 1
            while i < iM and zerun < LONGEST_LONG_RUN:
                if lengths[i + 1] > 0:
                    break
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= SHORTEST_LONG_RUN:
                    w.write(6, LONG_ZEROCODE_RUN)
                    w.write(8, zerun - SHORTEST_LONG_RUN)
                else:
                    w.write(6, SHORT_ZEROCODE_RUN + zerun - 2)
                i += 1
                continue
        w.write(6, l)
        i += 1
    return w.flush()


def _huf_unpack_enc_table(r: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = r.get_bits(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = r.get_bits(8) + SHORTEST_LONG_RUN
            if i + zerun > iM + 1:
                raise ValueError("PIZ: code-length table overrun")
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            if i + zerun > iM + 1:
                raise ValueError("PIZ: code-length table overrun")
            i += zerun
        else:
            lengths[i] = l
            i += 1
    # byte-align: the data bits start on the byte after the table
    r.lc = 0
    return _huf_canonical_code_table(lengths)


def _huf_build_enc_lengths(freq: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Code lengths for all symbols with freq > 0 (plus the run-length
    pseudo-symbol at iM = data_max + 1). Standard heapq Huffman; OpenEXR
    only requires *a* valid length assignment (the canonical code is
    derived from lengths on both sides)."""
    nz = np.nonzero(freq)[0]
    im = int(nz[0]) if len(nz) else 0
    data_max = int(nz[-1]) if len(nz) else 0
    iM = data_max + 1  # run-length pseudo-symbol
    freq = freq.copy()
    freq[iM] = 1
    syms = np.nonzero(freq)[0]
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths, im, iM
    heap: List = [(int(freq[s]), int(s), int(s)) for s in syms]
    heapq.heapify(heap)
    parent = {}
    next_id = HUF_ENCSIZE
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        heapq.heappush(heap, (f1 + f2, next_id, next_id))
        next_id += 1
    depth = {heap[0][2]: 0}

    def dep(node):
        if node in depth:
            return depth[node]
        d = dep(parent[node]) + 1
        depth[node] = d
        return d

    maxlen = 0
    for s in syms:
        lengths[s] = dep(int(s))
        maxlen = max(maxlen, lengths[s])
    if maxlen > 58:  # pathological: fall back to fixed-length codes
        fl = int(np.ceil(np.log2(len(syms))))
        lengths[:] = 0
        lengths[syms] = max(fl, 1)
    return lengths, im, iM


def _huf_encode(hcode: np.ndarray, data: np.ndarray, rlc: int) -> Tuple[bytes, int]:
    w = _BitWriter()
    codes = (hcode >> np.uint64(6)).astype(object)
    lens = (hcode & np.uint64(63)).astype(np.int64)
    rl_code, rl_len = int(codes[rlc]), int(lens[rlc])
    # run-length pass over the data (hufEncode): runs of up to 255 EXTRA
    # repeats collapse to symbol + RLC + 8-bit count when shorter
    vals = data.astype(np.int64)
    n = len(vals)
    i = 0
    while i < n:
        s = int(vals[i])
        j = i + 1
        while j < n and j - i <= 255 and vals[j] == s:
            j += 1
        cs = j - i - 1  # extra repeats
        s_code, s_len = int(codes[s]), int(lens[s])
        if s_len + rl_len + 8 < s_len * (cs + 1):
            w.write(s_len, s_code)
            w.write(rl_len, rl_code)
            w.write(8, cs)
        else:
            for _ in range(cs + 1):
                w.write(s_len, s_code)
        i = j
    nbits = w.bit_count()
    return w.flush(), nbits


def huf_compress(data: np.ndarray) -> bytes:
    """u16 symbol array -> OpenEXR Huffman stream (hufCompress)."""
    if len(data) == 0:
        return b""
    freq = np.bincount(data.astype(np.int64), minlength=HUF_ENCSIZE).astype(
        np.uint64
    )
    lengths, im, iM = _huf_build_enc_lengths(freq)
    hcode = _huf_canonical_code_table(lengths)
    table = _huf_pack_enc_table(hcode, im, iM)
    bits, nbits = _huf_encode(hcode, data, iM)
    head = struct.pack("<IIIII", im, iM, len(table), nbits, 0)
    return head + table + bits


def huf_uncompress(buf: bytes, n_out: int) -> np.ndarray:
    """OpenEXR Huffman stream -> u16 symbol array (hufUncompress)."""
    if n_out == 0:
        return np.zeros(0, np.uint16)
    if len(buf) < 20:
        raise ValueError("PIZ: Huffman stream too short")
    im, iM, _table_len, nbits, _ = struct.unpack_from("<IIIII", buf, 0)
    if im >= HUF_ENCSIZE or iM >= HUF_ENCSIZE:
        raise ValueError("PIZ: invalid Huffman table range")
    r = _BitReader(buf[20:])
    hcode = _huf_unpack_enc_table(r, im, iM)
    data_start = 20 + r.pos
    data = buf[data_start:]
    if nbits > 8 * len(data):
        raise ValueError("PIZ: Huffman data truncated")

    # decode tables: direct 14-bit lookup for short codes, candidate
    # lists for longer ones (hufBuildDecTable)
    lens = (hcode & np.uint64(63)).astype(np.int64)
    codes = (hcode >> np.uint64(6)).astype(np.uint64)
    dec_len = np.zeros(HUF_DECSIZE, np.int32)
    dec_lit = np.zeros(HUF_DECSIZE, np.int32)
    longs = {}
    for sym in np.nonzero(lens)[0]:
        l = int(lens[sym])
        c = int(codes[sym])
        if c >> l:
            raise ValueError("PIZ: invalid code table entry")
        if l > HUF_DECBITS:
            idx = c >> (l - HUF_DECBITS)
            if dec_len[idx]:
                raise ValueError("PIZ: invalid code table entry")
            longs.setdefault(idx, []).append(int(sym))
        else:
            base = c << (HUF_DECBITS - l)
            span = 1 << (HUF_DECBITS - l)
            if dec_len[base : base + span].any():
                raise ValueError("PIZ: invalid code table entry")
            dec_len[base : base + span] = l
            dec_lit[base : base + span] = sym

    out = np.zeros(n_out, np.uint16)
    o = 0
    rlc = iM
    c = 0
    lc = 0
    pos = 0
    nbytes = (nbits + 7) // 8
    dl = dec_len.tolist()
    dlit = dec_lit.tolist()
    lens_l = lens.tolist()
    codes_l = codes.tolist()
    while pos < nbytes:
        c = (c << 8) | data[pos]
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            l = dl[idx]
            if l:
                lc -= l
                sym = dlit[idx]
            else:
                cand = longs.get(idx)
                if not cand:
                    raise ValueError("PIZ: invalid Huffman code")
                for sym in cand:
                    cl = lens_l[sym]
                    while lc < cl and pos < nbytes:
                        c = (c << 8) | data[pos]
                        pos += 1
                        lc += 8
                    if lc >= cl and codes_l[sym] == (
                        (c >> (lc - cl)) & ((1 << cl) - 1)
                    ):
                        lc -= cl
                        break
                else:
                    raise ValueError("PIZ: invalid Huffman code")
            if sym == rlc:
                if lc < 8:
                    c = (c << 8) | data[pos]
                    pos += 1
                    lc += 8
                lc -= 8
                cs = (c >> lc) & 0xFF
                if o == 0 or o + cs > n_out:
                    raise ValueError("PIZ: run-length overrun")
                out[o : o + cs] = out[o - 1]
                o += cs
            else:
                if o >= n_out:
                    raise ValueError("PIZ: too much data")
                out[o] = sym
                o += 1
    # flush: drop the pad bits of the final byte, then finish short codes
    pad = (8 - nbits) & 7
    c >>= pad
    lc -= pad
    while lc > 0:
        idx = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        l = dl[idx]
        if l and l <= lc:
            lc -= l
            sym = dlit[idx]
            if sym == rlc:
                if lc < 8:
                    raise ValueError("PIZ: truncated run length")
                lc -= 8
                cs = (c >> lc) & 0xFF
                if o == 0 or o + cs > n_out:
                    raise ValueError("PIZ: run-length overrun")
                out[o : o + cs] = out[o - 1]
                o += cs
            else:
                if o >= n_out:
                    raise ValueError("PIZ: too much data")
                out[o] = sym
                o += 1
        else:
            break
    if o != n_out:
        raise ValueError(f"PIZ: expected {n_out} symbols, decoded {o}")
    return out


# ---------------------------------------------------------------------------
# PIZ chunk codec
# ---------------------------------------------------------------------------


def piz_uncompress(payload: bytes, width: int, ny: int,
                   channels: List[Tuple[str, int]]) -> bytes:
    """Decode one PIZ chunk to raw scanline-major bytes (the same layout
    ZIP/NONE chunks decode to: per scanline, per channel, a row of
    little-endian pixels). ``channels`` is [(name, bytes_per_pixel)] in
    file order; bytes_per_pixel is 2 (HALF) or 4 (FLOAT/UINT)."""
    min_nz, max_nz = struct.unpack_from("<HH", payload, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        nbytes = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(
            payload[pos : pos + nbytes], np.uint8
        )
        pos += nbytes
    lut, max_value = _reverse_lut_from_bitmap(bitmap)
    (huf_len,) = struct.unpack_from("<i", payload, pos)
    pos += 4
    sizes = [bpp // 2 for _, bpp in channels]  # shorts per pixel
    total = width * ny * sum(sizes)
    tmp = huf_uncompress(payload[pos : pos + huf_len], total)

    # per-channel wavelet decode (each short-plane separately)
    off = 0
    for size in sizes:
        count = width * ny * size
        chan = tmp[off : off + count].reshape(ny, width, size)
        for j in range(size):
            plane = np.ascontiguousarray(chan[:, :, j])
            wav2_decode(plane, max_value)
            chan[:, :, j] = plane
        off += count
    tmp = lut[tmp]  # applyLut

    # reassemble scanline-major
    out = bytearray()
    offs = np.cumsum([0] + [width * ny * s for s in sizes])
    for y in range(ny):
        for ci, size in enumerate(sizes):
            row = tmp[
                offs[ci] + y * width * size : offs[ci] + (y + 1) * width * size
            ]
            out += row.astype("<u2").tobytes()
    return bytes(out)


def piz_compress(raw: bytes, width: int, ny: int,
                 channels: List[Tuple[str, int]]) -> bytes:
    """Encode raw scanline-major bytes as one PIZ chunk (inverse of
    ``piz_uncompress``)."""
    sizes = [bpp // 2 for _, bpp in channels]
    total = width * ny * sum(sizes)
    rowshorts = width * np.array(sizes)
    data = np.frombuffer(raw, "<u2").copy()
    # scanline-major -> channel-major
    tmp = np.empty(total, np.uint16)
    offs = np.cumsum([0] + [width * ny * s for s in sizes])
    stride = int(rowshorts.sum())
    for y in range(ny):
        base = y * stride
        cb = 0
        for ci, size in enumerate(sizes):
            n = width * size
            tmp[offs[ci] + y * n : offs[ci] + (y + 1) * n] = data[
                base + cb : base + cb + n
            ]
            cb += n
    bitmap, min_nz, max_nz = _bitmap_from_data(tmp)
    lut, max_value = _forward_lut_from_bitmap(bitmap)
    tmp = lut[tmp]
    off = 0
    for size in sizes:
        count = width * ny * size
        chan = tmp[off : off + count].reshape(ny, width, size)
        for j in range(size):
            plane = np.ascontiguousarray(chan[:, :, j])
            wav2_encode(plane, max_value)
            chan[:, :, j] = plane
        off += count
    huf = huf_compress(tmp)
    out = struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz : max_nz + 1].tobytes()
    out += struct.pack("<i", len(huf))
    out += huf
    return out
