"""Raster G-buffer pipeline (the optional ENABLE_RASTER path).

Port of the reference's ``ops/raster.py`` (vulkan/pipeline_raster/
raster_scene_vulkan.{h,cpp}, basic.vert/frag): the scene's triangles are
projected with the pinhole camera and z-buffered into a G-buffer (albedo,
shading normal, depth, triangle id). The "rasterizer" is a dense batched
coverage test: for every batch of ``TRI_BATCH`` triangles the edge
functions of every pixel are evaluated at once and the nearest hit is kept
as a running z minimum over the batches; the winner's barycentrics are
then recomputed and made perspective-correct.

Cost scales with triangles x pixels, a small-scene debug path as in the
reference. Each batch step holds a dozen (TRI_BATCH, pixels) temporaries,
so the pixels go in blocks of ``PIXEL_BLOCK``; every pixel's result is its
own, so the blocks change no value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TRI_BATCH = 64
PIXEL_BLOCK = 1 << 17  # pixels per block: 64 x 131,072 f32 = 32 MiB a temporary


class GBuffer(NamedTuple):
    albedo: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W)
    tri: torch.Tensor  # (H, W) int32, -1 = background


def _project(view_pos, view_du, view_dv, view_tl, p):
    """World points (T, 3) -> (u, v, w): screen coordinates in [0, 1) and
    the depth along the camera basis, by solving rel = u du + v dv + w tl
    for each point (3x3 solve) and dividing by w."""
    rel = p - view_pos[None, :]
    m = torch.stack([view_du, view_dv, view_tl], dim=1)  # (3, 3)
    coeffs = torch.linalg.solve(m.expand(rel.shape[:-1] + (3, 3)),
                                rel[..., None])[..., 0]
    w = coeffs[..., 2]
    safe_w = torch.where(torch.abs(w) > 1e-9, w, 1e-9)
    return coeffs[..., 0] / safe_w, coeffs[..., 1] / safe_w, w


def _edges(bu0, bv0, bu1, bv1, bu2, bv2, pxg, pyg):
    """Screen-space edge functions and the signed area of each
    (triangle, pixel) pair, broadcast over the operands' shapes."""
    ax, ay = bu0 - pxg, bv0 - pyg
    bx, by = bu1 - pxg, bv1 - pyg
    cx, cy = bu2 - pxg, bv2 - pyg
    e01 = ax * by - ay * bx
    e12 = bx * cy - by * cx
    e20 = cx * ay - cy * ax
    return e01, e12, e20, e01 + e12 + e20


def _nearest(proj, ids, pxg, pyg, zbuf, best):
    """One batch of the z-buffer: the nearest covering triangle of each
    pixel among the batch's, merged into (zbuf, best) where strictly
    nearer."""
    bu0, bv0, bw0, bu1, bv1, bw1, bu2, bv2, bw2 = (a[:, None] for a in proj)
    e01, e12, e20, area = _edges(bu0, bv0, bu1, bv1, bu2, bv2,
                                 pxg[None, :], pyg[None, :])
    inside = (((e01 >= 0) & (e12 >= 0) & (e20 >= 0))
              | ((e01 <= 0) & (e12 <= 0) & (e20 <= 0)))
    big = torch.abs(area) > 1e-12
    inv_area = torch.where(big, 1.0 / area, 0.0)
    # screen-space barycentrics, made perspective-correct by 1/w
    l0, l1, l2 = e12 * inv_area, e20 * inv_area, e01 * inv_area
    iw = (l0 / torch.clamp(bw0, min=1e-9) + l1 / torch.clamp(bw1, min=1e-9)
          + l2 / torch.clamp(bw2, min=1e-9))
    z = 1.0 / torch.clamp(iw, min=1e-12)
    front = (bw0 > 0) & (bw1 > 0) & (bw2 > 0)
    valid = inside & front & big & (ids[:, None] >= 0)
    z = torch.where(valid, z, torch.inf)
    zi = torch.argmin(z, dim=0)  # the first nearest in the batch
    zmin = torch.gather(z, 0, zi[None, :])[0]
    improved = zmin < zbuf
    return torch.where(improved, zmin, zbuf), torch.where(improved, ids[zi], best)


def raster_gbuffer(v0, e1, e2, n0, n1, n2, base_color, tri_mat,
                   view_pos, view_du, view_dv, view_tl, width: int,
                   height: int) -> GBuffer:
    """Rasterise the triangle soup into a G-buffer.

    v0 / e1 / e2: (T, 3) world-space triangles; n0 / n1 / n2: (T, 3)
    corner normals; base_color: (M, 3) material colours; tri_mat: (T,)
    int32. view_*: the camera basis of ``OrientedCamera.view_basis``. All
    float32 tensors on one device."""
    dev = v0.device
    t = v0.shape[0]
    pad = (-t) % TRI_BATCH
    if pad:
        def padv(a):
            return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                             dtype=a.dtype, device=dev)])

        v0, e1, e2, n0, n1, n2 = (padv(a) for a in (v0, e1, e2, n0, n1, n2))
        tri_mat = torch.cat([tri_mat, torch.full((pad,), -1, dtype=torch.int32,
                                                 device=dev)])
    tp = v0.shape[0]
    # the three corners of every triangle, projected once
    u0, v0s, w0 = _project(view_pos, view_du, view_dv, view_tl, v0)
    u1, v1s, w1 = _project(view_pos, view_du, view_dv, view_tl, v0 + e1)
    u2, v2s, w2 = _project(view_pos, view_du, view_dv, view_tl, v0 + e2)
    # pixel centres in screen space, row-major
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    pxg = px[None, :].expand(height, width).reshape(-1)
    pyg = py[:, None].expand(height, width).reshape(-1)
    ids = torch.arange(tp, dtype=torch.int32, device=dev)
    ids = torch.where(ids < t, ids, -1)  # padding slots
    proj = (u0, v0s, w0, u1, v1s, w1, u2, v2s, w2)
    npix = width * height
    zbuf = torch.full((npix,), torch.inf, dtype=torch.float32, device=dev)
    best = torch.full((npix,), -1, dtype=torch.int32, device=dev)
    for p0 in range(0, npix, PIXEL_BLOCK):
        sl = slice(p0, min(p0 + PIXEL_BLOCK, npix))
        zb, bt = zbuf[sl], best[sl]
        for b0 in range(0, tp, TRI_BATCH):
            bs = slice(b0, b0 + TRI_BATCH)
            zb, bt = _nearest(tuple(a[bs] for a in proj), ids[bs], pxg[sl],
                              pyg[sl], zb, bt)
        zbuf[sl], best[sl] = zb, bt

    hit = best >= 0
    tri = torch.clamp(best, min=0).long()
    # the winner's barycentrics again, made perspective-correct
    e01, e12, e20, area = _edges(u0[tri], v0s[tri], u1[tri], v1s[tri],
                                 u2[tri], v2s[tri], pxg, pyg)
    inv_area = torch.where(torch.abs(area) > 1e-12, 1.0 / area, 0.0)
    l0s, l1s, l2s = e12 * inv_area, e20 * inv_area, e01 * inv_area
    q0 = l0s / torch.clamp(w0[tri], min=1e-9)
    q1 = l1s / torch.clamp(w1[tri], min=1e-9)
    q2 = l2s / torch.clamp(w2[tri], min=1e-9)
    qs = torch.clamp(q0 + q1 + q2, min=1e-12)
    b0, b1, b2 = q0 / qs, q1 / qs, q2 / qs
    nrm = n0[tri] * b0[:, None] + n1[tri] * b1[:, None] + n2[tri] * b2[:, None]
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                            min=1e-20)
    alb = base_color[torch.clamp(tri_mat[tri], min=0).long()]
    zero3 = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    return GBuffer(
        albedo=torch.where(hit[:, None], alb, zero3).reshape(height, width, 3),
        normal=torch.where(hit[:, None], nrm, zero3).reshape(height, width, 3),
        depth=torch.where(hit, zbuf, torch.inf).reshape(height, width),
        tri=torch.where(hit, best, -1).reshape(height, width),
    )
