"""Device texture atlas and filtered sampling (PyTorch).

Counterpart of the reference's ``ops/texture_atlas.py`` (:40-279), in its
compatibility layout only: every mip of every texture packed into ONE flat
texel array plus a descriptor table (offset, width, height per (texture,
mip)), sampled with gathers: the mip level's descriptor, its sRGB flag and
the four bilinear corners (7 gathers per lookup). The reference's
quad-packed rows and folded descriptors (``texels_quad``, ``desc4``,
``RPTR_ATLAS_QUAD``) cut the TPU's per-index gather cost and are not
ported; the descriptor table repeats the last real mip past a texture's
chain, so either layout reads the same texels.

Texels are u32 ABGR (r | g<<8 | b<<16 | a<<24) held as the bit pattern in
an int32 tensor: CPU torch has no uint32 add, shift or compare, and masks
after an arithmetic shift read the same bytes. Filtering stays in texel
space, then sRGB textures are linearised, as the reference does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

MAX_MIPS = 14


class TextureAtlas(NamedTuple):
    texels: torch.Tensor  # (P,) int32: the u32 ABGR bit pattern
    desc: torch.Tensor  # (T, MAX_MIPS, 3) int32: offset, width, height
    num_mips: torch.Tensor  # (T,) int32
    srgb: torch.Tensor  # (T,) bool: decode to linear after filtering

    @property
    def count(self) -> int:
        return self.desc.shape[0]


def build_atlas(textures: List, device="cpu") -> Optional[TextureAtlas]:
    """Pack a list of ``models.texture.Texture`` into an atlas on
    ``device``, the reference's (texture_atlas.py:69-145) texels and
    descriptors bit for bit; None if the list is empty."""
    if not textures:
        return None
    texel_parts = []
    desc = np.zeros((len(textures), MAX_MIPS, 3), np.int64)
    num_mips = np.zeros(len(textures), np.int32)
    srgb = np.zeros(len(textures), bool)
    cursor = 0
    for ti, tex in enumerate(textures):
        srgb[ti] = bool(tex.srgb)
        mips = tex.mips[:MAX_MIPS]
        if not mips:
            # an all-zero descriptor row would surface as remainder-by-0
            # and garbage texels at sample time: fail fast instead
            raise ValueError(f"texture {ti} has no mip levels")
        num_mips[ti] = len(mips)
        for mi, mip in enumerate(mips):
            h, w = mip.shape[:2]
            rgba = mip.astype(np.uint32)
            packed = (rgba[..., 0] | (rgba[..., 1] << 8) | (rgba[..., 2] << 16)
                      | (rgba[..., 3] << 24))
            desc[ti, mi] = (cursor, w, h)
            texel_parts.append(packed.reshape(-1))
            cursor += h * w
        for mi in range(len(mips), MAX_MIPS):
            desc[ti, mi] = desc[ti, len(mips) - 1]
    texels = np.concatenate(texel_parts).astype(np.uint32)
    return TextureAtlas(
        texels=torch.from_numpy(texels.view(np.int32)).to(device),
        desc=torch.from_numpy(desc.astype(np.int32)).to(device),
        num_mips=torch.from_numpy(num_mips).to(device),
        srgb=torch.from_numpy(srgb).to(device),
    )


def _unpack(px):
    """(N,) int32 ABGR texels -> (N, 4) f32 RGBA in [0, 1]."""
    ch = [((px >> s) & 0xFF).to(torch.float32) for s in (0, 8, 16, 24)]
    return torch.stack(ch, dim=-1) * (1.0 / 255.0)


def sample_atlas(atlas: TextureAtlas, tex_id, uv, mip_level):
    """Bilinear wrap sample. ``tex_id`` (N,) int (>= 0; callers mask), ``uv``
    (N, 2) f32, ``mip_level`` (N,) f32 -> (N, 4) linear f32."""
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    mip_r = torch.round(mip_level).to(torch.int64)
    nm = atlas.num_mips[tid].to(torch.int64)
    mip = torch.minimum(torch.clamp(mip_r, min=0), nm - 1)
    dd = atlas.desc[tid, mip].to(torch.int64)  # (N, 3)
    off, w, h = dd[:, 0], dd[:, 1], dd[:, 2]
    is_srgb = atlas.srgb[tid]

    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = uv[:, 0] * wf - 0.5
    y = uv[:, 1] * hf - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0.to(torch.float32))[:, None]
    fy = (y - y0.to(torch.float32))[:, None]
    x0w = torch.remainder(x0, w)
    y0w = torch.remainder(y0, h)
    x1w = torch.remainder(x0 + 1, w)
    y1w = torch.remainder(y0 + 1, h)
    p00 = _unpack(atlas.texels[off + y0w * w + x0w])
    p10 = _unpack(atlas.texels[off + y0w * w + x1w])
    p01 = _unpack(atlas.texels[off + y1w * w + x0w])
    p11 = _unpack(atlas.texels[off + y1w * w + x1w])
    out = (
        p00 * (1 - fx) * (1 - fy)
        + p10 * fx * (1 - fy)
        + p01 * (1 - fx) * fy
        + p11 * fx * fy
    )
    # sRGB textures: linearise after filtering
    rgb = out[:, :3]
    lin = torch.where(rgb <= 0.04045, rgb / 12.92,
                      torch.pow((rgb + 0.055) / 1.055, 2.4))
    rgb = torch.where(is_srgb[:, None], lin, rgb)
    return torch.cat([rgb, out[:, 3:4]], dim=-1)

