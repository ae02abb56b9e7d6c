"""The scene as the reference sees it: a ``.vks``-style scene (quantized
meshes, materials, textures, instance transforms) flattened to world-space
triangles with their shading attributes, materials, emitters and textures.

Frozen copy of the port's host scene path (``Scene.append_vkr_scene``,
``Scene.flatten_world``, ``_uv_mapping_attrs``; scene.cpp:665-747 in the
original renderer), reading the input scene by its fields only. Scenes with
LoD groups or animated transforms are not supported: the benchmark's
configurations have neither, and the reference refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from perfbench.reference.material import (
    BASE_MATERIAL_NOALPHA,
    BASE_MATERIAL_THIN,
    MaterialTable,
    translate_vkr_material,
)
from perfbench.reference.quantization import (
    dequantize_transforms,
    dequantize_vertices,
    unpack_normal_uv,
)


@dataclass
class FlatScene:
    """World-space SoA triangle soup + per-triangle shading attributes."""

    v0: np.ndarray  # (T, 3) f32
    e1: np.ndarray
    e2: np.ndarray
    n0: np.ndarray  # (T, 3) shading normals per corner
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # (T, 2)
    uv1: np.ndarray
    uv2: np.ndarray
    material_id: np.ndarray  # (T,) i32 global ids
    texel_density: np.ndarray = None  # (T,)
    tangent: np.ndarray = None  # (T, 4) xyz + handedness

    @property
    def num_tris(self) -> int:
        return len(self.material_id)


@dataclass
class SceneData:
    """Everything the reference derives from the input scene."""

    flat: FlatScene
    materials: MaterialTable
    material_flags: List[int]
    textures: List  # objects with ``mips`` (list of (h, w, 4) u8) and ``srgb``


def _materials(vs):
    """Materials and the scene's texture list (Scene.append_vkr_scene)."""
    mats, textures = [], []
    for vm in vs.materials:
        base_tex = normal_tex = spec_tex = -1
        if vm.tex_base_color is not None:
            base_tex = len(textures)
            textures.append(vm.tex_base_color)
        if vm.tex_normal is not None:
            normal_tex = len(textures)
            textures.append(vm.tex_normal)
        if vm.tex_specular is not None:
            spec_tex = len(textures)
            textures.append(vm.tex_specular)
        mat = translate_vkr_material(vm, base_tex, normal_tex, spec_tex)
        # fully-opaque base textures never alpha-test
        if (vm.tex_base_color is not None and vm.tex_base_color.mips
                and int(vm.tex_base_color.mips[0][..., 3].min()) == 255):
            mat.flags |= BASE_MATERIAL_NOALPHA
        # name-keyword shader assignment (scene.cpp:678-706)
        uname = vm.name.upper()
        if "_SHADERMATERIAL_SIMPLIFIED" in uname:
            mat.roughness = 1.0
            mat.metallic = 0.0
            mat.specular = 0.0
            mat.specular_transmission = 0.0
        elif "_SHADERMATERIAL_THIN_TRANSMISSION" in uname:
            mat.specular_transmission = max(mat.specular_transmission, 1.0)
            mat.flags |= BASE_MATERIAL_THIN
        elif "_SHADERMATERIAL_TRANSMISSION" in uname:
            mat.specular_transmission = max(mat.specular_transmission, 1.0)
        mats.append(mat)
    return mats, textures


def _mesh_material_ids(vm) -> np.ndarray:
    """Per-triangle local material ids (scene.cpp:665-676)."""
    if vm.num_segments == 1 and vm.num_materials_in_range > 1:
        return (np.asarray(vm.material_ids, np.int32)
                + np.int32(vm.material_id_buffer_base))
    return np.repeat(np.asarray(vm.segment_material_base_offsets, np.int32),
                     np.asarray(vm.segment_num_triangles, np.int64))


def load_scene(vs) -> SceneData:
    """Flatten a static ``.vks``-style scene to world space at frame 0."""
    if vs.num_animated_transforms:
        raise NotImplementedError("the reference renders static scenes only")
    if any(len(g.mesh_ids) > 1 for g in vs.lod_groups):
        raise NotImplementedError("the reference renders scenes without LoD")
    mats, textures = _materials(vs)
    xforms = dequantize_transforms(vs.transforms_q[
        [inst.transform_index for inst in vs.instances]])
    parts = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0",
                             "uv1", "uv2", "material_id")}
    for inst, xform in zip(vs.instances, xforms):
        vm = vs.meshes[inst.mesh_id]
        lin, tr = xform[:, :3].astype(np.float32), xform[:, 3].astype(np.float32)
        lin_it = np.linalg.inv(lin).T.astype(np.float32)
        p = dequantize_vertices(vm.vertices_q, vm.vertex_scale,
                                vm.vertex_offset).reshape(-1, 3, 3)
        n, uv = unpack_normal_uv(vm.normal_uv_q)
        n, uv = n.reshape(-1, 3, 3), uv.reshape(-1, 3, 2)
        pw = p @ lin.T + tr
        nw = n @ lin_it.T
        nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)
        parts["v0"].append(pw[:, 0])
        parts["e1"].append(pw[:, 1] - pw[:, 0])
        parts["e2"].append(pw[:, 2] - pw[:, 0])
        for k in range(3):
            parts[f"n{k}"].append(nw[:, k])
            parts[f"uv{k}"].append(uv[:, k])
        # one material offset per scene: the scene's meshes index its own
        # materials from 0
        parts["material_id"].append(_mesh_material_ids(vm))
    flat = FlatScene(**{
        k: (np.concatenate(v).astype(np.int32) if k == "material_id" else
            np.ascontiguousarray(np.concatenate(v, axis=0), np.float32))
        for k, v in parts.items()})
    flat.texel_density, flat.tangent = _uv_mapping_attrs(flat)
    return SceneData(flat=flat, materials=MaterialTable.from_materials(mats),
                     material_flags=[m.flags for m in mats], textures=textures)


def _uv_mapping_attrs(flat: FlatScene):
    """Per-triangle texel density (uv area / world area, for mip selection)
    and uv-aligned tangent frame (for normal mapping)."""
    duv1 = flat.uv1 - flat.uv0
    duv2 = flat.uv2 - flat.uv0
    uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    gn = np.cross(flat.e1, flat.e2)
    world_area = 0.5 * np.linalg.norm(gn, axis=-1)
    density = np.sqrt(uv_area / np.maximum(world_area, 1e-20)).astype(np.float32)

    # tangent along +u (standard uv-basis derivation)
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    r = np.where(np.abs(det) > 1e-20, 1.0 / np.where(det == 0, 1, det), 0.0)
    tangent = (flat.e1 * duv2[:, 1:2] - flat.e2 * duv1[:, 1:2]) * r[:, None]
    tl = np.linalg.norm(tangent, axis=-1, keepdims=True)
    fallback = np.zeros_like(tangent)
    fallback[:, 0] = 1.0
    tangent = np.where(tl > 1e-12, tangent / np.maximum(tl, 1e-20), fallback)
    bitangent = (flat.e2 * duv1[:, 0:1] - flat.e1 * duv2[:, 0:1]) * r[:, None]
    handed = np.where(
        np.sum(np.cross(gn, tangent) * bitangent, axis=-1) >= 0.0, 1.0, -1.0
    ).astype(np.float32)
    return density, np.concatenate([tangent.astype(np.float32), handed[:, None]],
                                   axis=1)
