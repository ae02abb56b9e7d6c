"""``village``: about 80k textured triangles (grid 200: 80,496), a frozen
copy of the port's ``procedural.village``: a noise heightfield ground with
a tiled base-colour and roughness texture, 48 box buildings with a brick
texture and a normal map, and 8 emissive window quads (16 triangles)."""

from __future__ import annotations

import numpy as np

from perfbench.scenes.vks import (
    Texture,
    VkrMaterial,
    height_grid,
    identity_scene,
    make_mesh,
    mip_chain,
    quad,
    value_noise_heights,
)


def _tex_rgba(f, size=64, srgb=True):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rgb = np.clip(f(xx, yy) * 255.0, 0, 255).astype(np.uint8)
    rgba = np.concatenate([rgb, np.full((size, size, 1), 255, np.uint8)], axis=-1)
    return Texture(size, size, 37, mips=mip_chain(rgba), srgb=srgb)


def build(grid: int = 200, extent: float = 24.0, seed: int = 13):
    rng = np.random.default_rng(seed)
    n = grid + 1
    h = value_noise_heights(n, 1.2, seed)
    tris = height_grid(n, extent, h)
    uvs = (tris[..., [0, 2]] + extent / 2) * (8.0 / extent)
    ground = make_mesh("ground", tris, tri_uvs=uvs.astype(np.float32))

    def cell(cx, cz):
        ix = int(np.clip((cx + extent / 2) / extent * (n - 1), 0, n - 1))
        iz = int(np.clip((cz + extent / 2) / extent * (n - 1), 0, n - 1))
        return float(h[ix, iz])

    boxes = []
    for _ in range(48):
        cx, cz = rng.uniform(-extent * 0.4, extent * 0.4, 2)
        w, d = rng.uniform(0.6, 1.6, 2)
        ht = rng.uniform(0.8, 2.4)
        y0 = cell(cx, cz) - 0.05
        x0, x1 = cx - w / 2, cx + w / 2
        z0, z1 = cz - d / 2, cz + d / 2
        y1 = y0 + ht
        boxes.append(np.concatenate([
            quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),
            quad([x1, y0, z1], [x0, y0, z1], [x0, y1, z1], [x1, y1, z1]),
            quad([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]),
            quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]),
            quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),
        ], axis=0))
    box_tris = np.concatenate(boxes, axis=0)
    box_uvs = np.zeros((len(box_tris), 3, 2), np.float32)
    box_uvs[:, 1, 0] = 2.0
    box_uvs[:, 2, 1] = 2.0
    buildings = make_mesh("buildings", box_tris, tri_uvs=box_uvs, material_base=1)

    lights = []
    for _ in range(8):
        cx, cz = rng.uniform(-extent * 0.35, extent * 0.35, 2)
        y = cell(cx, cz) + rng.uniform(1.0, 2.0)
        s = 0.35
        lights.append(quad([cx - s, y, cz - s], [cx + s, y, cz - s],
                           [cx + s, y + s, cz + s], [cx - s, y + s, cz + s]))
    light_mesh = make_mesh("windows", np.concatenate(lights, axis=0),
                           material_base=2)

    gnoise = rng.uniform(0.3, 1.0, (8, 8)).astype(np.float32)

    def ground_f(xx, yy):
        g = gnoise[(yy * 8).astype(int) % 8, (xx * 8).astype(int) % 8]
        return np.stack([0.45 * g, 0.42 * g, 0.30 * g], axis=-1)

    def brick_f(xx, yy):
        row = (yy * 8).astype(int)
        mortar = ((yy * 8) % 1.0 < 0.12) | (((xx * 4 + (row % 2) * 0.5) % 1.0) < 0.08)
        base = np.stack([0.55 * np.ones_like(xx), 0.28 * np.ones_like(xx),
                         0.20 * np.ones_like(xx)], axis=-1)
        return np.where(mortar[..., None], 0.75, base)

    def rough_f(xx, yy):
        r = 0.55 + 0.4 * ((xx * 8).astype(int) % 2 == (yy * 8).astype(int) % 2)
        return np.stack([np.zeros_like(xx), r, np.zeros_like(xx)], axis=-1)

    def normal_f(xx, yy):
        ny = 0.5 + 0.12 * np.sin(xx * 25.0)
        nx = 0.5 + 0.12 * np.cos(yy * 25.0)
        return np.stack([nx, ny, np.ones_like(xx)], axis=-1)

    materials = [
        VkrMaterial(name="ground", tex_base_color=_tex_rgba(ground_f),
                    tex_specular=_tex_rgba(rough_f, srgb=False)),
        VkrMaterial(name="brick", tex_base_color=_tex_rgba(brick_f),
                    tex_normal=_tex_rgba(normal_f, srgb=False)),
        VkrMaterial(name="window",
                    emitter_base_color=np.array([1.0, 0.85, 0.6], np.float32),
                    emission_intensity=14.0),
    ]
    return identity_scene([ground, buildings, light_mesh], materials)
