"""Procedural test scene builders.

The reference ships no scene assets; its validation configs operate on small
`.vks` scenes. These builders create VkrScene objects (quantized, identical
to what the Blender exporter would emit) used for golden-image tests and the
validation configs (BASELINE.md config 1/2).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from realtimepathtracingresearchframework_tpu_torch.models import vkr
from realtimepathtracingresearchframework_tpu_torch.models.quantization import (
    pack_normal_uv,
    quantize_transforms,
    quantize_vertices,
)


def make_mesh(
    name: str,
    tri_vertices: np.ndarray,
    tri_normals: Optional[np.ndarray] = None,
    tri_uvs: Optional[np.ndarray] = None,
    material_ids: Optional[np.ndarray] = None,
    num_materials: int = 1,
    material_base: int = 0,
) -> vkr.VkrMesh:
    """Build a quantized VkrMesh from triangle soup.

    tri_vertices: (T, 3, 3) float; implicit indices (3 verts per tri), the
    rendering-side requirement of the format (vkr.h:418-420).
    """
    tri_vertices = np.asarray(tri_vertices, np.float32)
    t = tri_vertices.shape[0]
    flat = tri_vertices.reshape(-1, 3)

    if tri_normals is None:
        e1 = tri_vertices[:, 1] - tri_vertices[:, 0]
        e2 = tri_vertices[:, 2] - tri_vertices[:, 0]
        gn = np.cross(e1, e2)
        gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        tri_normals = np.repeat(gn[:, None, :], 3, axis=1)
    if tri_uvs is None:
        tri_uvs = np.zeros((t, 3, 2), np.float32)
        tri_uvs[:, 1, 0] = 1.0
        tri_uvs[:, 2, 1] = 1.0
    if material_ids is None:
        material_ids = np.zeros(t, np.uint8)

    vq, scale, offset = quantize_vertices(flat)
    nq = pack_normal_uv(
        np.asarray(tri_normals, np.float64).reshape(-1, 3),
        np.asarray(tri_uvs, np.float64).reshape(-1, 2),
    )

    mesh = vkr.VkrMesh(
        name=name,
        vertex_scale=scale,
        vertex_offset=offset,
        num_triangles=t,
        num_materials_in_range=num_materials,
        segment_num_triangles=[t],
        segment_material_base_offsets=[material_base],
        vertices_q=vq,
        normal_uv_q=nq,
        material_ids=np.asarray(material_ids, np.uint8),
    )
    return mesh


def _quad(p0, p1, p2, p3) -> np.ndarray:
    """Two triangles for quad p0..p3 (counter-clockwise)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])])


def identity_scene(
    meshes: List[vkr.VkrMesh],
    materials: List[vkr.VkrMaterial],
    transforms: Optional[np.ndarray] = None,
) -> vkr.VkrScene:
    """One instance per mesh with (default identity) static transforms."""
    n = len(meshes)
    if transforms is None:
        transforms = np.zeros((n, 3, 4), np.float32)
        transforms[:, :, :3] = np.eye(3)
    scene = vkr.VkrScene(
        materials=materials,
        meshes=meshes,
        instances=[
            vkr.VkrInstance(name=m.name, mesh_id=i, transform_index=i)
            for i, m in enumerate(meshes)
        ],
        lod_groups=[vkr.VkrLodGroup()],
        num_static_transforms=n,
        transforms_q=quantize_transforms(transforms),
    )
    return scene


def cornell_box(light: bool = True) -> vkr.VkrScene:
    """The classic box: white floor/ceiling/back, red/green walls, two blocks,
    optional area light. Camera convention: y-up, box in [-1,1]^2 x [0,2]."""
    tris = []
    mats = []

    def add(quads, mat_id):
        for q in quads:
            tris.append((q, mat_id))

    white, red, green, lightm = 0, 1, 2, 3
    # floor y=0, ceiling y=2, back z=-1 (opening towards +z)
    add([_quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1])], white)
    add([_quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])], white)
    add([_quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1])], white)
    add([_quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1])], red)
    add([_quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1])], green)

    def box(cx, cz, w, d, h, rot_deg):
        c, s = np.cos(np.radians(rot_deg)), np.sin(np.radians(rot_deg))
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        corners = []
        for dx in (-w / 2, w / 2):
            for dz in (-d / 2, d / 2):
                p = R @ np.array([dx, 0, dz], np.float32)
                corners.append([cx + p[0], 0.0, cz + p[2]])
        (a, b_, c_, d_) = corners  # a=(-,-), b=(-,+), c=(+,-), d=(+,+)
        top = [[p[0], h, p[2]] for p in (a, b_, c_, d_)]
        quads = [
            _quad(top[0], top[2], top[3], top[1]),  # top
            _quad(a, b_, top[1], top[0]),  # -x side
            _quad(c_, top[2], top[3], d_),  # +x side (note winding unimportant, two-sided)
            _quad(a, top[0], top[2], c_),  # -z side
            _quad(b_, d_, top[3], top[1]),  # +z side
        ]
        return quads

    for q in box(-0.35, -0.35, 0.6, 0.6, 1.2, 18):
        add([q], white)
    for q in box(0.4, 0.35, 0.55, 0.55, 0.6, -15):
        add([q], white)

    if light:
        eps = 1.999
        add(
            [_quad([-0.3, eps, -0.3], [0.3, eps, -0.3], [0.3, eps, 0.3], [-0.3, eps, 0.3])],
            lightm,
        )

    all_tris = np.concatenate([t for t, _ in tris], axis=0)
    mat_ids = np.concatenate(
        [np.full(len(t), m, np.uint8) for t, m in tris], axis=0
    )

    materials = [
        vkr.VkrMaterial(name="White", base_color=np.array([0.73, 0.73, 0.73], np.float32)),
        vkr.VkrMaterial(name="Red", base_color=np.array([0.61, 0.06, 0.06], np.float32)),
        vkr.VkrMaterial(name="Green", base_color=np.array([0.12, 0.45, 0.15], np.float32)),
        vkr.VkrMaterial(
            name="Light",
            emission_intensity=12.0,
            emitter_base_color=np.array([1.0, 0.9, 0.75], np.float32),
        ),
    ]
    mesh = make_mesh(
        "cornell", all_tris, material_ids=mat_ids, num_materials=len(materials)
    )
    return identity_scene([mesh], materials)


def _value_noise_heights(n: int, height: float, seed: int) -> np.ndarray:
    """(n, n) heightfield: four octaves of bilinear lattice value noise,
    normalized to ±height. Shared by terrain() and village() so their
    ground surfaces (and village's building placement on it) stay in
    sync by construction."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 1, n, dtype=np.float32)
    h = np.zeros((n, n), np.float32)
    for octave in range(4):
        res = 4 * (2 ** octave)
        lattice = rng.normal(0, 1, (res + 1, res + 1)).astype(np.float32)
        fx = xs * res
        ix = np.minimum(fx.astype(np.int32), res - 1)
        tx = fx - ix
        a = lattice[ix][:, ix]  # (n, n) via outer indexing
        b = lattice[ix + 1][:, ix]
        c = lattice[ix][:, ix + 1]
        d = lattice[ix + 1][:, ix + 1]
        txc = tx[:, None] * np.ones((1, n), np.float32)
        tyc = tx[None, :] * np.ones((n, 1), np.float32)
        h += ((a * (1 - txc) + b * txc) * (1 - tyc)
              + (c * (1 - txc) + d * txc) * tyc) * (0.6 ** octave)
    return h / np.abs(h).max() * height


def terrain(grid: int = 500, extent: float = 20.0, height: float = 2.0,
            seed: int = 7) -> vkr.VkrScene:
    """Large structured scene: a value-noise heightfield of ``2*grid^2``
    triangles (grid=500 -> 500k) — config 5 "large quantized
    scene" workload and the streamed-traversal capability bar
    (render_vulkan.cpp:472-545 handles multi-million-tri BLAS batches)."""
    n = grid + 1
    h = _value_noise_heights(n, height, seed)

    gx, gz = np.meshgrid(
        np.linspace(-extent / 2, extent / 2, n, dtype=np.float32),
        np.linspace(-extent / 2, extent / 2, n, dtype=np.float32),
        indexing="ij",
    )
    verts = np.stack([gx, h, gz], axis=-1)  # (n, n, 3)

    p00 = verts[:-1, :-1]
    p10 = verts[1:, :-1]
    p01 = verts[:-1, 1:]
    p11 = verts[1:, 1:]
    tri_a = np.stack([p00, p10, p11], axis=2)
    tri_b = np.stack([p00, p11, p01], axis=2)
    tris = np.concatenate([tri_a, tri_b], axis=2).reshape(-1, 3, 3)

    materials = [
        vkr.VkrMaterial(
            name="Ground",
            base_color=np.array([0.45, 0.42, 0.32], np.float32),
        ),
    ]
    mesh = make_mesh("terrain", tris, num_materials=1)
    return identity_scene([mesh], materials)


def single_triangle() -> vkr.VkrScene:
    """Minimal one-triangle scene for loader and traversal smoke tests."""
    tri = np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)
    mesh = make_mesh("tri", tri)
    return identity_scene([mesh], [vkr.VkrMaterial(name="Default")])


def _mip_chain(rgba: np.ndarray) -> list:
    """Full RGBA8 mip chain by 2x2 box filter (the atlas expects complete
    chains like vkt textures ship)."""
    mips = [rgba]
    m = rgba
    while m.shape[0] > 1 or m.shape[1] > 1:
        h = max(m.shape[0] // 2, 1)
        w = max(m.shape[1] // 2, 1)
        m = (
            m.astype(np.uint16)
            .reshape(h, m.shape[0] // h, w, m.shape[1] // w, 4)
            .mean(axis=(1, 3))
            .astype(np.uint8)
        )
        mips.append(m)
    return mips


def village(grid: int = 200, extent: float = 24.0, seed: int = 13) -> vkr.VkrScene:
    """~80k-triangle TEXTURED benchmark scene (the reference's default
    workload is a real textured scene at 1080p, README.md:77): a noise
    heightfield ground with a tiled base-color + roughness texture,
    box "buildings" with a brick-like texture and normal map, and
    emissive window quads driving binned-RIS NEE. Sized to stay on the
    resident Pallas traversal (< 90k tris)."""
    from realtimepathtracingresearchframework_tpu_torch.models.texture import Texture

    rng = np.random.default_rng(seed)

    # same heightfield as terrain(), with tiling uvs added
    n = grid + 1
    gx, gz = np.meshgrid(
        np.linspace(-extent / 2, extent / 2, n, dtype=np.float32),
        np.linspace(-extent / 2, extent / 2, n, dtype=np.float32),
        indexing="ij",
    )
    h = _value_noise_heights(n, 1.2, seed)
    verts = np.stack([gx, h, gz], axis=-1)
    p00, p10 = verts[:-1, :-1], verts[1:, :-1]
    p01, p11 = verts[:-1, 1:], verts[1:, 1:]
    tri_a = np.stack([p00, p10, p11], axis=2)
    tri_b = np.stack([p00, p11, p01], axis=2)
    tris = np.concatenate([tri_a, tri_b], axis=2).reshape(-1, 3, 3)
    uv_scale = 8.0 / extent
    uvs = (tris[..., [0, 2]] + extent / 2) * uv_scale  # (T, 3, 2) tiling
    ground = make_mesh("ground", tris, tri_uvs=uvs.astype(np.float32))

    # buildings: axis-aligned boxes on the ground (12 tris each)
    boxes = []
    for _ in range(48):
        cx, cz = rng.uniform(-extent * 0.4, extent * 0.4, 2)
        w, d = rng.uniform(0.6, 1.6, 2)
        ht = rng.uniform(0.8, 2.4)
        ix = int(np.clip((cx + extent / 2) / extent * (n - 1), 0, n - 1))
        iz = int(np.clip((cz + extent / 2) / extent * (n - 1), 0, n - 1))
        y0 = float(h[ix, iz]) - 0.05
        x0, x1 = cx - w / 2, cx + w / 2
        z0, z1 = cz - d / 2, cz + d / 2
        y1 = y0 + ht
        quads = [
            _quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),
            _quad([x1, y0, z1], [x0, y0, z1], [x0, y1, z1], [x1, y1, z1]),
            _quad([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]),
            _quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]),
            _quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),
        ]
        boxes.append(np.concatenate(quads, axis=0))
    box_tris = np.concatenate(boxes, axis=0)
    box_uvs = np.zeros((len(box_tris), 3, 2), np.float32)
    box_uvs[:, 1, 0] = 2.0
    box_uvs[:, 2, 1] = 2.0
    buildings = make_mesh("buildings", box_tris, tri_uvs=box_uvs,
                          material_base=1)

    # emissive window quads (area lights for binned-RIS NEE)
    lights = []
    for _ in range(8):
        cx, cz = rng.uniform(-extent * 0.35, extent * 0.35, 2)
        ix = int(np.clip((cx + extent / 2) / extent * (n - 1), 0, n - 1))
        iz = int(np.clip((cz + extent / 2) / extent * (n - 1), 0, n - 1))
        y = float(h[ix, iz]) + rng.uniform(1.0, 2.0)
        s = 0.35
        lights.append(_quad([cx - s, y, cz - s], [cx + s, y, cz - s],
                            [cx + s, y + s, cz + s], [cx - s, y + s, cz + s]))
    light_mesh = make_mesh("windows", np.concatenate(lights, axis=0),
                           material_base=2)

    # textures: tiled noise ground (sRGB), brick-ish walls + normal map,
    # roughness-in-green specular map (scene.cpp:946-951 channel layout)
    def tex_rgba(f, size=64, srgb=True):
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        rgb = np.clip(f(xx, yy) * 255.0, 0, 255).astype(np.uint8)
        rgba = np.concatenate(
            [rgb, np.full((size, size, 1), 255, np.uint8)], axis=-1
        )
        return Texture(size, size, 37, mips=_mip_chain(rgba), srgb=srgb)

    gnoise = rng.uniform(0.3, 1.0, (8, 8)).astype(np.float32)

    def ground_f(xx, yy):
        g = gnoise[(yy * 8).astype(int) % 8, (xx * 8).astype(int) % 8]
        return np.stack([0.45 * g, 0.42 * g, 0.30 * g], axis=-1)

    def brick_f(xx, yy):
        row = (yy * 8).astype(int)
        mortar = ((yy * 8) % 1.0 < 0.12) | (
            ((xx * 4 + (row % 2) * 0.5) % 1.0) < 0.08
        )
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
        vkr.VkrMaterial(
            name="ground",
            tex_base_color=tex_rgba(ground_f),
            tex_specular=tex_rgba(rough_f, srgb=False),
        ),
        vkr.VkrMaterial(
            name="brick",
            tex_base_color=tex_rgba(brick_f),
            tex_normal=tex_rgba(normal_f, srgb=False),
        ),
        vkr.VkrMaterial(
            name="window",
            emitter_base_color=np.array([1.0, 0.85, 0.6], np.float32),
            emission_intensity=14.0,
        ),
    ]
    vs = identity_scene([ground, buildings, light_mesh], materials)
    return vs


def instanced_field(num_inst: int = 600, frames: int = 16,
                    extent: float = 30.0, seed: int = 5) -> vkr.VkrScene:
    """Instanced ANIMATED benchmark scene: ``num_inst`` transformed
    copies of three unique meshes (rock / tree / tower) spinning over a
    ground plane, with per-frame animated transforms driving the TLAS
    refit path (default_update_tlas, render_vulkan.cpp:1219-1366).
    Sized past the resident two-level kernel's caps (instances > 512)
    so it exercises the streamed TLAS kernel
    (ops/traverse_tlas_stream.py) end-to-end."""
    rng = np.random.default_rng(seed)

    # rock: displaced lat-long sphere (~2k tris)
    def sphere_tris(nu, nv, bump):
        u = np.linspace(0, 2 * np.pi, nu + 1)
        v = np.linspace(1e-3, np.pi - 1e-3, nv + 1)
        uu, vv = np.meshgrid(u, v, indexing="ij")
        r = 1.0 + bump * _value_noise_heights(max(nu, nv) + 1, 1.0, seed)[
            : nu + 1, : nv + 1
        ]
        p = np.stack(
            [
                r * np.sin(vv) * np.cos(uu),
                r * np.cos(vv),
                r * np.sin(vv) * np.sin(uu),
            ],
            axis=-1,
        ).astype(np.float32)
        p00, p10 = p[:-1, :-1], p[1:, :-1]
        p01, p11 = p[:-1, 1:], p[1:, 1:]
        ta = np.stack([p00, p10, p11], axis=2)
        tb = np.stack([p00, p11, p01], axis=2)
        return np.concatenate([ta, tb], axis=2).reshape(-1, 3, 3)

    rock = make_mesh("rock", sphere_tris(32, 32, 0.35))

    # tree: cone canopy + trunk quads (~1k tris)
    def cone_tris(nu, rings, r0, y0, y1):
        u = np.linspace(0, 2 * np.pi, nu + 1)
        y = np.linspace(y0, y1, rings + 1)
        uu, yy = np.meshgrid(u, y, indexing="ij")
        rr = r0 * (y1 - yy) / (y1 - y0)
        p = np.stack(
            [rr * np.cos(uu), yy, rr * np.sin(uu)], axis=-1
        ).astype(np.float32)
        p00, p10 = p[:-1, :-1], p[1:, :-1]
        p01, p11 = p[:-1, 1:], p[1:, 1:]
        ta = np.stack([p00, p10, p11], axis=2)
        tb = np.stack([p00, p11, p01], axis=2)
        return np.concatenate([ta, tb], axis=2).reshape(-1, 3, 3)

    tree_tris = np.concatenate(
        [
            cone_tris(24, 10, 0.8, 0.6, 2.6),
            cone_tris(8, 4, 0.15, 0.0, 0.7),
        ]
    )
    tree = make_mesh("tree", tree_tris, material_base=1)

    # tower: stacked shrinking boxes (~120 tris)
    def box_quads(x0, y0, z0, x1, y1, z1):
        return np.concatenate(
            [
                _quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),
                _quad([x1, y0, z1], [x0, y0, z1], [x0, y1, z1], [x1, y1, z1]),
                _quad([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]),
                _quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]),
                _quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),
            ]
        )

    tower_tris = np.concatenate(
        [
            box_quads(-s, 1.6 * i, -s, s, 1.6 * (i + 1), s)
            for i, s in enumerate((0.8, 0.6, 0.4))
        ]
    )
    tower = make_mesh("tower", tower_tris, material_base=2)

    ground = make_mesh(
        "ground",
        _quad(
            [-extent, 0, -extent], [extent, 0, -extent],
            [extent, 0, extent], [-extent, 0, extent],
        ),
        material_base=3,
    )

    meshes = [rock, tree, tower, ground]
    base = cornell_box().materials
    materials = [base[0], base[1], base[2], base[0]]

    # static transform 0: ground identity. Animated 1..num_inst: spin +
    # bob per frame (quantized transform table layout: statics first,
    # then frames x animated blocks — vkr.c:199-209)
    instances = [
        vkr.VkrInstance(name="ground", mesh_id=3, transform_index=0)
    ]
    centers = rng.uniform(-extent * 0.8, extent * 0.8, (num_inst, 2))
    scales = rng.uniform(0.5, 1.4, num_inst)
    phases = rng.uniform(0, 2 * np.pi, num_inst)
    rates = rng.uniform(0.5, 2.0, num_inst) * (2 * np.pi / frames)
    mesh_pick = rng.integers(0, 3, num_inst)
    for i in range(num_inst):
        instances.append(
            vkr.VkrInstance(
                name=f"inst{i}", mesh_id=int(mesh_pick[i]),
                transform_index=1 + i,
            )
        )

    xf_static = np.zeros((1, 3, 4), np.float32)
    xf_static[0, :, :3] = np.eye(3)
    frames_xf = []
    for f in range(frames):
        a = phases + rates * f
        ca, sa = np.cos(a), np.sin(a)
        xf = np.zeros((num_inst, 3, 4), np.float32)
        xf[:, 0, 0] = ca * scales
        xf[:, 0, 2] = sa * scales
        xf[:, 1, 1] = scales
        xf[:, 2, 0] = -sa * scales
        xf[:, 2, 2] = ca * scales
        xf[:, 0, 3] = centers[:, 0]
        xf[:, 1, 3] = 0.15 + 0.1 * (1 + np.sin(a))
        xf[:, 2, 3] = centers[:, 1]
        frames_xf.append(xf)
    all_xf = np.concatenate([xf_static] + frames_xf, axis=0)

    return vkr.VkrScene(
        materials=materials,
        meshes=meshes,
        instances=instances,
        lod_groups=[vkr.VkrLodGroup()],
        num_frames=frames,
        num_static_transforms=1,
        num_animated_transforms=num_inst,
        animation_step=1.0 / 24.0,
        transforms_q=quantize_transforms(all_xf),
    )
