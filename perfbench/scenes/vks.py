"""The ``.vks`` scene as the renderer and the reference read it: the scene
records (the fields and defaults of the port's ``models/vkr.py`` and
``models/texture.py``), the format's vertex and normal/uv encoders
(``models/quantization.py``), and the procedural builders' shared pieces
(``models/procedural.py``). Frozen copies: the port's modules are not
imported, so the input the cells render does not move with them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

VKS_VERSION = 4
QMAX = float(0x1FFFFF)  # 21 bits per axis


@dataclass
class Texture:
    width: int
    height: int
    format: int
    mips: List[np.ndarray] = field(default_factory=list)  # each (h, w, 4) u8
    srgb: bool = False

    @property
    def num_mips(self) -> int:
        return len(self.mips)


@dataclass
class VkrMaterial:
    name: str
    extended_name: str = ""
    base_color: Optional[np.ndarray] = None
    emitter_base_color: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    emission_intensity: float = 0.0
    specular_transmission: float = 0.0
    ior_eta: float = 1.5
    ior_k: float = 0.0
    translucency: float = 0.0
    tex_base_color: Optional[Texture] = None
    tex_normal: Optional[Texture] = None
    tex_specular: Optional[Texture] = None
    features: list = field(default_factory=list)
    tensors: list = field(default_factory=list)


@dataclass
class VkrMesh:
    name: str = ""
    vertex_scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    vertex_offset: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    flags: int = 0
    num_triangles: int = 0
    material_id_buffer_base: int = 0
    num_materials_in_range: int = 0
    lod_group: int = 0
    segment_num_triangles: List[int] = field(default_factory=list)
    segment_material_base_offsets: List[int] = field(default_factory=list)
    vertices_q: Optional[np.ndarray] = None  # (3*T,) u64
    normal_uv_q: Optional[np.ndarray] = None  # (3*T,) u64
    material_ids: Optional[np.ndarray] = None  # (T,) u8
    indices: Optional[np.ndarray] = None  # implicit: 3 vertices a triangle

    @property
    def num_segments(self) -> int:
        return len(self.segment_num_triangles)

    @property
    def aabb(self):
        lo = self.vertex_offset
        hi = self.vertex_offset + self.vertex_scale * QMAX
        return np.minimum(lo, hi), np.maximum(lo, hi)


@dataclass
class VkrInstance:
    name: str = ""
    mesh_id: int = 0
    transform_index: int = 0
    flags: int = 0


@dataclass
class VkrLodGroup:
    mesh_ids: List[int] = field(default_factory=list)
    detail_reduction: List[float] = field(default_factory=list)

    @property
    def num_levels_of_detail(self) -> int:
        return len(self.mesh_ids)


@dataclass
class VkrScene:
    version: int = VKS_VERSION
    materials: List[VkrMaterial] = field(default_factory=list)
    meshes: List[VkrMesh] = field(default_factory=list)
    instances: List[VkrInstance] = field(default_factory=list)
    lod_groups: List[VkrLodGroup] = field(default_factory=list)
    animation_start: float = 0.0
    animation_step: float = 0.0
    num_frames: int = 1
    num_static_transforms: int = 0
    num_animated_transforms: int = 0
    transforms_q: Optional[np.ndarray] = None  # (N, 24) u8
    texture_dir: str = ""

    @property
    def num_triangles(self) -> int:
        return sum(m.num_triangles for m in self.meshes)


def quantize_vertices(v: np.ndarray):
    """(N, 3) positions -> (N,) u64 of 3 x 21-bit fixed point, with the
    per-axis (scale, offset) of the positions' box."""
    v = np.asarray(v, dtype=np.float32)
    vmin, vmax = v.min(axis=0), v.max(axis=0)
    extent = np.maximum(vmax - vmin, 1e-12)
    scale = (extent / QMAX).astype(np.float32)
    offset = vmin.astype(np.float32)
    q = np.clip(np.rint((v - offset) / scale), 0, QMAX).astype(np.uint64)
    vq = q[:, 0] | (q[:, 1] << np.uint64(21)) | (q[:, 2] << np.uint64(42))
    return vq, scale, offset


def _quantize_normal(n: np.ndarray) -> np.ndarray:
    """(N, 3) unit normals -> (N,) u32, L1-octahedral 16 + 16 bits."""
    n = np.asarray(n, dtype=np.float64)
    n = n / np.maximum(np.abs(n).sum(axis=-1, keepdims=True), 1e-20)
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    fx = (1.0 - np.abs(y)) * np.where(x >= 0.0, 1.0, -1.0)
    fy = (1.0 - np.abs(x)) * np.where(y >= 0.0, 1.0, -1.0)
    ox = np.where(z < 0.0, fx, x)
    oy = np.where(z < 0.0, fy, y)
    qx = np.clip(np.rint(ox * 0x7FFF) + 0x8000, 0, 0xFFFF).astype(np.uint32)
    qy = np.clip(np.rint(oy * 0x7FFF) + 0x8000, 0, 0xFFFF).astype(np.uint32)
    return qx | (qy << np.uint32(16))


def _quantize_uv(uv: np.ndarray) -> np.ndarray:
    """(N, 2) uv in u [0, 8], v [-7, 1] -> (N,) u32, 16 + 16 bits."""
    uv = np.asarray(uv, dtype=np.float64)
    s = float(0xFFFF) / 8.0
    qu = np.clip(np.rint(uv[:, 0] * s), 0, 0xFFFF).astype(np.uint32)
    qv = np.clip(np.rint((1.0 - uv[:, 1]) * s), 0, 0xFFFF).astype(np.uint32)
    return qu | (qv << np.uint32(16))


def pack_normal_uv(n: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """(N, 3) + (N, 2) -> (N,) u64: normal in the low 32 bits, uv high."""
    return _quantize_normal(n).astype(np.uint64) | (
        _quantize_uv(uv).astype(np.uint64) << np.uint64(32))


def identity_transforms(n: int) -> np.ndarray:
    """(n, 24) u8 quantized identity transforms: translation 0 (3 x f32),
    scale 1 (f32), the stored quaternion (0, 0, 0, -1) as u16
    floor((q / 2 + 1 / 2) * 65535 - 1 / 2) clipped at 0."""
    out = np.zeros((n, 24), np.uint8)
    out[:, 12:16] = np.array([1.0], "<f4").view(np.uint8)
    out[:, 16:24] = np.array([32767, 32767, 32767, 0], "<u2").view(np.uint8)
    return out


def make_mesh(name: str, tri_vertices: np.ndarray, tri_uvs=None,
              num_materials: int = 1, material_base: int = 0) -> VkrMesh:
    """A quantized mesh of a triangle soup (T, 3, 3), flat normals,
    implicit indices, material 0 of its range on every triangle."""
    tri_vertices = np.asarray(tri_vertices, np.float32)
    t = tri_vertices.shape[0]
    e1 = tri_vertices[:, 1] - tri_vertices[:, 0]
    e2 = tri_vertices[:, 2] - tri_vertices[:, 0]
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    tri_normals = np.repeat(gn[:, None, :], 3, axis=1)
    if tri_uvs is None:
        tri_uvs = np.zeros((t, 3, 2), np.float32)
        tri_uvs[:, 1, 0] = 1.0
        tri_uvs[:, 2, 1] = 1.0
    vq, scale, offset = quantize_vertices(tri_vertices.reshape(-1, 3))
    nq = pack_normal_uv(np.asarray(tri_normals, np.float64).reshape(-1, 3),
                        np.asarray(tri_uvs, np.float64).reshape(-1, 2))
    return VkrMesh(
        name=name, vertex_scale=scale, vertex_offset=offset, num_triangles=t,
        num_materials_in_range=num_materials, segment_num_triangles=[t],
        segment_material_base_offsets=[material_base], vertices_q=vq,
        normal_uv_q=nq, material_ids=np.zeros(t, np.uint8))


def quad(p0, p1, p2, p3) -> np.ndarray:
    """Two triangles for the quad p0..p3 (counter-clockwise)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])])


def identity_scene(meshes: List[VkrMesh], materials: List[VkrMaterial]) -> VkrScene:
    """One instance per mesh, each with a static identity transform."""
    n = len(meshes)
    return VkrScene(
        materials=materials, meshes=meshes,
        instances=[VkrInstance(name=m.name, mesh_id=i, transform_index=i)
                   for i, m in enumerate(meshes)],
        lod_groups=[VkrLodGroup()], num_static_transforms=n,
        transforms_q=identity_transforms(n))


def value_noise_heights(n: int, height: float, seed: int) -> np.ndarray:
    """(n, n) heightfield: four octaves of bilinear lattice value noise,
    normalised to +-height."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 1, n, dtype=np.float32)
    h = np.zeros((n, n), np.float32)
    for octave in range(4):
        res = 4 * (2 ** octave)
        lattice = rng.normal(0, 1, (res + 1, res + 1)).astype(np.float32)
        fx = xs * res
        ix = np.minimum(fx.astype(np.int32), res - 1)
        tx = fx - ix
        a = lattice[ix][:, ix]
        b = lattice[ix + 1][:, ix]
        c = lattice[ix][:, ix + 1]
        d = lattice[ix + 1][:, ix + 1]
        txc = tx[:, None] * np.ones((1, n), np.float32)
        tyc = tx[None, :] * np.ones((n, 1), np.float32)
        h += ((a * (1 - txc) + b * txc) * (1 - tyc)
              + (c * (1 - txc) + d * txc) * tyc) * (0.6 ** octave)
    return h / np.abs(h).max() * height


def height_grid(n: int, extent: float, h: np.ndarray) -> np.ndarray:
    """(2 (n-1)^2, 3, 3) triangles of the (n, n) heightfield ``h`` over
    [-extent/2, extent/2]^2."""
    gx, gz = np.meshgrid(
        np.linspace(-extent / 2, extent / 2, n, dtype=np.float32),
        np.linspace(-extent / 2, extent / 2, n, dtype=np.float32),
        indexing="ij")
    verts = np.stack([gx, h, gz], axis=-1)
    p00, p10 = verts[:-1, :-1], verts[1:, :-1]
    p01, p11 = verts[:-1, 1:], verts[1:, 1:]
    tri_a = np.stack([p00, p10, p11], axis=2)
    tri_b = np.stack([p00, p11, p01], axis=2)
    return np.concatenate([tri_a, tri_b], axis=2).reshape(-1, 3, 3)


def mip_chain(rgba: np.ndarray) -> list:
    """The full RGBA8 mip chain of ``rgba`` by 2x2 box filter."""
    mips = [rgba]
    m = rgba
    while m.shape[0] > 1 or m.shape[1] > 1:
        h = max(m.shape[0] // 2, 1)
        w = max(m.shape[1] // 2, 1)
        m = (m.astype(np.uint16)
             .reshape(h, m.shape[0] // h, w, m.shape[1] // w, 4)
             .mean(axis=(1, 3)).astype(np.uint8))
        mips.append(m)
    return mips
