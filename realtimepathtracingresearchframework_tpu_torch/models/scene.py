"""Scene container — the render-facing scene model.

Equivalent of ``librender/scene.{h,cpp}`` (``Scene``, :48-108) +
``librender/mesh.h`` (Geometry/Mesh/ParameterizedMesh/Instance, :10-116):
meshes with quantized buffers, parameterized meshes binding materials to
geometry, instances with animated transform indices, materials, textures,
lights, and revision counters driving incremental device updates.

TPU representation: ``flatten_world()`` decodes + transforms everything into
a world-space struct-of-arrays triangle soup (``FlatScene``) consumed by the
BVH builder and the integrators. Instancing with a two-level BVH keeps the
per-mesh structure (see ops/bvh.py TLAS support).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from realtimepathtracingresearchframework_tpu_torch.models import vkr as vkr_mod
from realtimepathtracingresearchframework_tpu_torch.models.material import (
    BaseMaterial,
    MaterialTable,
    translate_vkr_material,
)
from realtimepathtracingresearchframework_tpu_torch.models.quantization import (
    dequantize_vertices,
    unpack_normal_uv,
)
from realtimepathtracingresearchframework_tpu_torch.utils.error_io import info, warning
from realtimepathtracingresearchframework_tpu_torch.utils.profiling import ProfilingScope


@dataclass
class Geometry:
    """One geometry: triangle soup with implicit indices.

    Reference: ``Geometry`` (librender/mesh.h:10-40); kept quantized until
    flatten, like the mmap-to-upload path (scene.cpp:622-644).
    """

    vertices_q: np.ndarray  # (3T,) u64
    normal_uv_q: np.ndarray  # (3T,) u64
    scale: np.ndarray  # (3,) f32
    offset: np.ndarray  # (3,) f32
    material_ids: np.ndarray  # (T,) local material ids
    indices: Optional[np.ndarray] = None  # (3T,) u32 BVH quad-formation hints

    @property
    def num_tris(self) -> int:
        return len(self.material_ids)

    def decode_positions(self) -> np.ndarray:
        return dequantize_vertices(self.vertices_q, self.scale, self.offset).reshape(
            -1, 3, 3
        )

    def decode_normals_uvs(self):
        n, uv = unpack_normal_uv(self.normal_uv_q)
        return n.reshape(-1, 3, 3), uv.reshape(-1, 3, 2)


@dataclass
class Mesh:
    """A group of geometries (librender/mesh.h Mesh)."""

    name: str = ""
    geometries: List[Geometry] = field(default_factory=list)
    lod_group: int = 0

    @property
    def num_tris(self) -> int:
        return sum(g.num_tris for g in self.geometries)


@dataclass
class ParameterizedMesh:
    """Mesh + material binding (librender/mesh.h ParameterizedMesh):
    per-segment or per-triangle material assignment resolved to global
    material ids at flatten time."""

    mesh_id: int
    material_offset: int  # added to geometry-local material ids
    per_triangle_materials: bool = True


@dataclass
class Instance:
    """Placed parameterized mesh (librender/mesh.h Instance)."""

    parameterized_mesh_id: int
    transform_index: int = 0
    animation_data_index: int = 0


@dataclass
class AnimationData:
    """Quantized transform table (scene.cpp:713-729)."""

    num_static: int = 0
    num_animated: int = 0
    num_frames: int = 1
    start: float = 0.0
    step: float = 0.0
    transforms_q: Optional[np.ndarray] = None  # (N, 24) u8

    def transform(self, index: int, frame: int = 0) -> np.ndarray:
        from realtimepathtracingresearchframework_tpu_torch.models.quantization import (
            dequantize_transforms,
        )

        if index < self.num_static:
            off = index
        else:
            off = self.num_static + (index - self.num_static) + frame * self.num_animated
        return dequantize_transforms(self.transforms_q[off : off + 1])[0]

    def transforms_for_frame(self, indices: np.ndarray, frame: int) -> np.ndarray:
        from realtimepathtracingresearchframework_tpu_torch.models.quantization import (
            dequantize_transforms,
        )

        indices = np.asarray(indices, np.int64)
        offs = np.where(
            indices < self.num_static,
            indices,
            self.num_static
            + (indices - self.num_static)
            + frame * self.num_animated,
        )
        return dequantize_transforms(self.transforms_q[offs])


@dataclass
class LodGroup:
    mesh_ids: List[int] = field(default_factory=list)
    detail_reduction: List[float] = field(default_factory=list)


@dataclass
class FlatScene:
    """World-space SoA triangle soup + tables, ready for BVH build/upload."""

    v0: np.ndarray  # (T,3) f32
    e1: np.ndarray  # (T,3)
    e2: np.ndarray  # (T,3)
    n0: np.ndarray  # (T,3) shading normals per corner
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # (T,2)
    uv1: np.ndarray
    uv2: np.ndarray
    material_id: np.ndarray  # (T,) i32 global ids
    instance_id: np.ndarray  # (T,) i32
    texel_density: np.ndarray = None  # (T,) uv-units per world-unit
    tangent: np.ndarray = None  # (T,4) uv-aligned tangent xyz + handedness

    @property
    def num_tris(self) -> int:
        return len(self.material_id)


@dataclass
class CameraDesc:
    """A scene-provided camera (librender/scene.h:60 CameraDesc): used
    as the startup viewpoint when the user gives no camera args
    (scene_state.cpp:45-49, ``--camera <n>`` selects among several)."""

    position: np.ndarray
    center: np.ndarray
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov_y: float = 65.0


class Scene:
    """Scene container with revision tracking (librender/scene.h:48-108)."""

    def __init__(self):
        self.meshes: List[Mesh] = []
        self.parameterized_meshes: List[ParameterizedMesh] = []
        self.instances: List[Instance] = []
        self.materials: List[BaseMaterial] = []
        self.material_names: List[str] = []
        self.textures: List = []  # texture_mod.Texture
        self.animation_data: List[AnimationData] = [AnimationData(num_static=1)]
        self.lod_groups: List[LodGroup] = []
        self.cameras: List[CameraDesc] = []  # scene.h:60 (empty for .vks)
        self.revision = 0
        self.lights_revision = 0

    # -- stats (librender/scene.h:77-84)
    @property
    def unique_tris(self) -> int:
        return sum(m.num_tris for m in self.meshes)

    @property
    def total_tris(self) -> int:
        return sum(
            self.meshes[self.parameterized_meshes[i.parameterized_mesh_id].mesh_id].num_tris
            for i in self.instances
        )

    @property
    def num_geometries(self) -> int:
        return sum(len(m.geometries) for m in self.meshes)

    @property
    def total_texture_bytes(self) -> int:
        return sum(
            sum(mip.nbytes for mip in t.mips) for t in self.textures if t is not None
        )

    def info_string(self) -> str:
        return (
            f"{self.unique_tris} unique tris, {self.total_tris} instanced, "
            f"{self.num_geometries} geometries, {len(self.materials)} materials, "
            f"{self.total_texture_bytes / 1e6:.1f} MB textures"
        )

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    @staticmethod
    def from_vks(paths: Sequence[str], load_textures: bool = True) -> "Scene":
        scene = Scene()
        scene.animation_data = []
        for p in paths:
            with ProfilingScope(f"load {os.path.basename(p)}"):
                vs = vkr_mod.open_scene(p, load_textures=load_textures)
                scene.append_vkr_scene(vs)
        return scene

    @staticmethod
    def from_vkr_scene(vs: vkr_mod.VkrScene) -> "Scene":
        scene = Scene()
        scene.animation_data = []
        scene.append_vkr_scene(vs)
        return scene

    def append_vkr_scene(self, vs: vkr_mod.VkrScene) -> None:
        mesh_base = len(self.meshes)
        mat_base = len(self.materials)
        lod_base = len(self.lod_groups)

        # materials (+ textures)
        for vm in vs.materials:
            base_tex = normal_tex = spec_tex = -1
            if vm.tex_base_color is not None:
                base_tex = len(self.textures)
                self.textures.append(vm.tex_base_color)
            if vm.tex_normal is not None:
                normal_tex = len(self.textures)
                self.textures.append(vm.tex_normal)
            if vm.tex_specular is not None:
                spec_tex = len(self.textures)
                self.textures.append(vm.tex_specular)
            mat = translate_vkr_material(vm, base_tex, normal_tex, spec_tex)
            # fully-opaque base textures never alpha-test (the reference
            # keys this off the texture format; we key off actual texels)
            if (
                vm.tex_base_color is not None
                and vm.tex_base_color.mips
                and int(vm.tex_base_color.mips[0][..., 3].min()) == 255
            ):
                from realtimepathtracingresearchframework_tpu_torch.models.material import (
                    BASE_MATERIAL_NOALPHA,
                )

                mat.flags |= BASE_MATERIAL_NOALPHA
            # name-keyword shader assignment (scene.cpp:678-706): artists
            # force a shading path by embedding _SHADERMATERIAL_<KIND> in
            # the material name. On TPU the hit-shader selection is
            # data-driven, so keywords resolve to material parameters.
            uname = vm.name.upper()
            if "_SHADERMATERIAL_SIMPLIFIED" in uname:
                mat.roughness = 1.0
                mat.metallic = 0.0
                mat.specular = 0.0
                mat.specular_transmission = 0.0
            elif "_SHADERMATERIAL_THIN_TRANSMISSION" in uname:
                # THIN_TRANSMISSION_HIT (vulkan/CMakeLists.txt:38-39):
                # transmission keeps the material roughness, reflective
                # specular takes sqrt(clearcoat_gloss)
                from realtimepathtracingresearchframework_tpu_torch.models.material import (  # noqa: E501
                    BASE_MATERIAL_THIN,
                )

                mat.specular_transmission = max(mat.specular_transmission, 1.0)
                mat.flags |= BASE_MATERIAL_THIN
            elif "_SHADERMATERIAL_TRANSMISSION" in uname:
                mat.specular_transmission = max(mat.specular_transmission, 1.0)
            self.materials.append(mat)
            self.material_names.append(vm.name)

        # meshes. Material assignment follows scene.cpp:665-676: the
        # per-triangle material-id buffer is honored only for single-segment
        # meshes with more than one material in range; otherwise each
        # segment's triangles take segmentMaterialBaseOffsets[seg] and the
        # id buffer is ignored.
        for vm in vs.meshes:
            if vm.num_segments == 1 and vm.num_materials_in_range > 1:
                tri_mat_ids = np.asarray(vm.material_ids, np.int32) + np.int32(
                    vm.material_id_buffer_base
                )
            else:
                tri_mat_ids = np.repeat(
                    np.asarray(vm.segment_material_base_offsets, np.int32),
                    np.asarray(vm.segment_num_triangles, np.int64),
                )
            geom = Geometry(
                vertices_q=vm.vertices_q,
                normal_uv_q=vm.normal_uv_q,
                scale=vm.vertex_scale,
                offset=vm.vertex_offset,
                material_ids=tri_mat_ids,
                indices=vm.indices,
            )
            self.meshes.append(
                Mesh(name=vm.name, geometries=[geom], lod_group=lod_base + vm.lod_group)
            )
            self.parameterized_meshes.append(
                ParameterizedMesh(
                    mesh_id=len(self.meshes) - 1, material_offset=mat_base
                )
            )

        # lod groups
        for g in vs.lod_groups:
            self.lod_groups.append(
                LodGroup(
                    mesh_ids=[mesh_base + int(m) for m in g.mesh_ids],
                    detail_reduction=list(g.detail_reduction),
                )
            )

        # animation
        anim = AnimationData(
            num_static=vs.num_static_transforms,
            num_animated=vs.num_animated_transforms,
            num_frames=vs.num_frames,
            start=vs.animation_start,
            step=vs.animation_step,
            transforms_q=vs.transforms_q,
        )
        anim_index = len(self.animation_data)
        self.animation_data.append(anim)

        # instances: only base-LoD levels become instances (scene.cpp:736-747)
        for vi in vs.instances:
            vmesh = vs.meshes[vi.mesh_id]
            lod = vs.lod_groups[vmesh.lod_group] if vs.lod_groups else None
            if lod and lod.num_levels_of_detail > 0 and lod.mesh_ids[0] != vi.mesh_id:
                continue
            self.instances.append(
                Instance(
                    parameterized_mesh_id=mesh_base + vi.mesh_id,
                    transform_index=vi.transform_index,
                    animation_data_index=anim_index,
                )
            )

        self.revision += 1
        self.lights_revision += 1

    # ------------------------------------------------------------------
    # Flatten to world-space SoA (consumed by BVH build + integrators)
    # ------------------------------------------------------------------

    def deduplicate(self) -> dict:
        """Merge identical meshes / parameterized meshes and drop orphans —
        the ``--deduplicate-scene`` pass (cmdline flag, main.cpp; dedup on
        mesh buffer identity like scene.cpp's shared-geometry reuse).

        Returns a summary dict {"meshes_removed": n, "pmeshes_removed": m}.
        Safe by construction: instances are remapped to canonical ids, so
        flatten_world output is unchanged."""

        def mesh_content_key(m: Mesh):
            parts = []
            for g in m.geometries:
                parts.append(g.vertices_q.tobytes())
                parts.append(g.normal_uv_q.tobytes())
                parts.append(np.asarray(g.scale, np.float32).tobytes())
                parts.append(np.asarray(g.offset, np.float32).tobytes())
                parts.append(np.asarray(g.material_ids).tobytes())
            return hash(b"".join(parts))

        content = [mesh_content_key(m) for m in self.meshes]

        # canonical LoD groups by content (appended scenes each bring their
        # own group ids; identical groups must merge for meshes to merge)
        lg_canon: dict = {}
        lg_remap = {}
        for gi, lg in enumerate(self.lod_groups):
            k = (
                tuple(content[m] for m in lg.mesh_ids),
                tuple(lg.detail_reduction),
            )
            lg_remap[gi] = lg_canon.setdefault(k, gi)
        for m in self.meshes:
            m.lod_group = lg_remap.get(m.lod_group, m.lod_group)

        # canonical mesh per (content, lod binding)
        canon: dict = {}
        mesh_remap = {}
        for i, m in enumerate(self.meshes):
            k = (content[i], m.lod_group)
            if k in canon:
                mesh_remap[i] = canon[k]
            else:
                canon[k] = i
                mesh_remap[i] = i
        for pm in self.parameterized_meshes:
            pm.mesh_id = mesh_remap[pm.mesh_id]
        for lg in self.lod_groups:
            lg.mesh_ids = [
                mesh_remap.get(i, i) for i in lg.mesh_ids
            ]

        # canonical parameterized mesh per (mesh, materials) binding
        pm_canon: dict = {}
        pm_remap = {}
        for i, pm in enumerate(self.parameterized_meshes):
            k = (pm.mesh_id, pm.material_offset, pm.per_triangle_materials)
            if k in pm_canon:
                pm_remap[i] = pm_canon[k]
            else:
                pm_canon[k] = i
                pm_remap[i] = i
        for inst in self.instances:
            inst.parameterized_mesh_id = pm_remap[inst.parameterized_mesh_id]

        # GC: drop unreferenced parameterized meshes, then meshes
        used_pm = sorted({i.parameterized_mesh_id for i in self.instances})
        pm_new_ids = {old: new for new, old in enumerate(used_pm)}
        pmeshes_removed = len(self.parameterized_meshes) - len(used_pm)
        self.parameterized_meshes = [self.parameterized_meshes[i] for i in used_pm]
        for inst in self.instances:
            inst.parameterized_mesh_id = pm_new_ids[inst.parameterized_mesh_id]

        used_m_set = {pm.mesh_id for pm in self.parameterized_meshes}
        # LoD variant meshes are reachable only through their group —
        # instances point at the base level (append_vkr_scene) — so GC
        # must keep every member of a group a surviving mesh belongs to,
        # or LoD selection is silently destroyed
        for gi in {
            self.meshes[i].lod_group
            for i in used_m_set
            if self.meshes[i].lod_group < len(self.lod_groups)
        }:
            used_m_set.update(
                mid
                for mid in self.lod_groups[gi].mesh_ids
                if 0 <= mid < len(self.meshes)
            )
        used_m = sorted(used_m_set)
        m_new_ids = {old: new for new, old in enumerate(used_m)}
        meshes_removed = len(self.meshes) - len(used_m)
        self.meshes = [self.meshes[i] for i in used_m]
        for pm in self.parameterized_meshes:
            pm.mesh_id = m_new_ids[pm.mesh_id]
        for lg in self.lod_groups:
            lg.mesh_ids = [m_new_ids[i] for i in lg.mesh_ids if i in m_new_ids]

        if meshes_removed or pmeshes_removed:
            self.revision += 1
            info(
                f"deduplicate: removed {meshes_removed} meshes, "
                f"{pmeshes_removed} parameterized meshes"
            )
        return {
            "meshes_removed": meshes_removed,
            "pmeshes_removed": pmeshes_removed,
        }

    def select_lod(self, mesh_id: int, xform, camera_pos, lod_threshold: float) -> int:
        """Distance-based LoD level selection (util/lod.{h,cpp}): pick the
        coarsest level whose screen-space error (detail_reduction x bound
        radius / distance) stays under the threshold. Level 0 = base."""
        mesh = self.meshes[mesh_id]
        group = (
            self.lod_groups[mesh.lod_group]
            if mesh.lod_group < len(self.lod_groups)
            else None
        )
        if camera_pos is None or group is None or len(group.mesh_ids) < 2:
            return mesh_id
        geom = mesh.geometries[0]
        radius = 0.5 * float(
            np.linalg.norm(geom.scale.astype(np.float64) * float(0x1FFFFF))
        )
        scale = float(np.cbrt(abs(np.linalg.det(xform[:, :3])) + 1e-20))
        center = xform[:, 3]
        dist = max(float(np.linalg.norm(np.asarray(camera_pos) - center)), 1e-3)
        selected = group.mesh_ids[0]
        for mid, reduction in zip(group.mesh_ids, group.detail_reduction):
            err = reduction * radius * scale / dist
            if err <= lod_threshold:
                selected = mid
        return selected

    def lod_selection(
        self, camera_pos, lod_threshold: float = 0.02, frame: int = 0
    ) -> tuple:
        """Per-instance selected mesh ids — the LoD signature a renderer
        compares across camera moves to decide whether the flattened
        geometry (and its acceleration structure) must be rebuilt
        (util/lod.cpp distance selection; TLAS per-LoD BLAS offset,
        render_vulkan.cpp:1244-1248)."""
        sel = []
        for inst in self.instances:
            pm = self.parameterized_meshes[inst.parameterized_mesh_id]
            anim = self.animation_data[inst.animation_data_index]
            xform = anim.transform(inst.transform_index, frame)
            sel.append(
                self.select_lod(pm.mesh_id, xform, camera_pos, lod_threshold)
            )
        return tuple(sel)

    def has_lod_groups(self) -> bool:
        return any(len(g.mesh_ids) > 1 for g in self.lod_groups)

    def flatten_world(
        self,
        frame: int = 0,
        camera_pos=None,
        lod_threshold: float = 0.02,
    ) -> FlatScene:
        v0s, e1s, e2s = [], [], []
        n0s, n1s, n2s = [], [], []
        uv0s, uv1s, uv2s = [], [], []
        mats, insts = [], []
        # each transform row and each geometry decoded once, not once per
        # instance (the decodes are row-wise, so the arrays are the same)
        xforms = {}
        for a, anim in enumerate(self.animation_data):
            ii = [i for i, inst in enumerate(self.instances)
                  if inst.animation_data_index == a]
            if ii:
                rows = anim.transforms_for_frame(
                    [self.instances[i].transform_index for i in ii], frame)
                xforms.update(zip(ii, rows))
        decoded = {}
        for ii, inst in enumerate(self.instances):
            pm = self.parameterized_meshes[inst.parameterized_mesh_id]
            xform = xforms[ii]
            lod_mesh_id = self.select_lod(pm.mesh_id, xform, camera_pos, lod_threshold)
            mesh = self.meshes[lod_mesh_id]
            lin, tr = xform[:, :3].astype(np.float32), xform[:, 3].astype(np.float32)
            # normal transform: inverse-transpose of linear part
            lin_it = np.linalg.inv(lin).T.astype(np.float32)
            for geom in mesh.geometries:
                if id(geom) not in decoded:
                    decoded[id(geom)] = (geom.decode_positions(),  # (T,3,3)
                                         *geom.decode_normals_uvs())
                p, n, uv = decoded[id(geom)]
                pw = p @ lin.T + tr
                nw = n @ lin_it.T
                nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)
                v0s.append(pw[:, 0])
                e1s.append(pw[:, 1] - pw[:, 0])
                e2s.append(pw[:, 2] - pw[:, 0])
                n0s.append(nw[:, 0])
                n1s.append(nw[:, 1])
                n2s.append(nw[:, 2])
                uv0s.append(uv[:, 0])
                uv1s.append(uv[:, 1])
                uv2s.append(uv[:, 2])
                mats.append(
                    geom.material_ids.astype(np.int32) + np.int32(pm.material_offset)
                )
                insts.append(np.full(geom.num_tris, ii, np.int32))

        cat = lambda xs: np.ascontiguousarray(np.concatenate(xs, axis=0), np.float32)
        flat = FlatScene(
            v0=cat(v0s),
            e1=cat(e1s),
            e2=cat(e2s),
            n0=cat(n0s),
            n1=cat(n1s),
            n2=cat(n2s),
            uv0=cat(uv0s),
            uv1=cat(uv1s),
            uv2=cat(uv2s),
            material_id=np.concatenate(mats).astype(np.int32),
            instance_id=np.concatenate(insts).astype(np.int32),
        )
        flat.texel_density, flat.tangent = _uv_mapping_attrs(flat)
        return flat

    def flatten_meshes(self):
        """Object-space per-mesh flatten for the two-level path: one
        FlatScene concatenating every mesh in OBJECT space (material ids
        LOCAL — the per-instance material offset is applied at shading
        time), plus per-mesh triangle soups for BLAS builds and the
        per-instance (mesh_id, material_offset) binding tables.

        Returns (flat, mesh_tris, instance_mesh_ids, instance_mat_offsets,
        instance_transforms(frame 0))."""
        v0s, e1s, e2s = [], [], []
        n0s, n1s, n2s = [], [], []
        uv0s, uv1s, uv2s = [], [], []
        mats, insts = [], []
        mesh_tris = []
        for mi, mesh in enumerate(self.meshes):
            mv0, me1, me2 = [], [], []
            for geom in mesh.geometries:
                p = geom.decode_positions()
                n, uv = geom.decode_normals_uvs()
                v0s.append(p[:, 0])
                e1s.append(p[:, 1] - p[:, 0])
                e2s.append(p[:, 2] - p[:, 0])
                mv0.append(p[:, 0])
                me1.append(p[:, 1] - p[:, 0])
                me2.append(p[:, 2] - p[:, 0])
                n0s.append(n[:, 0])
                n1s.append(n[:, 1])
                n2s.append(n[:, 2])
                uv0s.append(uv[:, 0])
                uv1s.append(uv[:, 1])
                uv2s.append(uv[:, 2])
                mats.append(geom.material_ids.astype(np.int32))
                insts.append(np.full(geom.num_tris, mi, np.int32))
            mesh_tris.append(
                (
                    np.concatenate(mv0),
                    np.concatenate(me1),
                    np.concatenate(me2),
                )
            )
        cat = lambda xs: np.ascontiguousarray(np.concatenate(xs, axis=0), np.float32)
        flat = FlatScene(
            v0=cat(v0s),
            e1=cat(e1s),
            e2=cat(e2s),
            n0=cat(n0s),
            n1=cat(n1s),
            n2=cat(n2s),
            uv0=cat(uv0s),
            uv1=cat(uv1s),
            uv2=cat(uv2s),
            material_id=np.concatenate(mats).astype(np.int32),
            instance_id=np.concatenate(insts).astype(np.int32),
        )
        flat.texel_density, flat.tangent = _uv_mapping_attrs(flat)
        mesh_ids = [
            self.parameterized_meshes[i.parameterized_mesh_id].mesh_id
            for i in self.instances
        ]
        mat_offsets = [
            self.parameterized_meshes[i.parameterized_mesh_id].material_offset
            for i in self.instances
        ]
        return flat, mesh_tris, mesh_ids, mat_offsets

    def instance_transforms(self, frame: int = 0) -> np.ndarray:
        """(I,3,4) decoded world transforms for one animation frame — the
        TLAS update input (default_update_tlas, render_vulkan.cpp:1219)."""
        return np.stack(
            [
                self.animation_data[i.animation_data_index].transform(
                    i.transform_index, frame
                )
                for i in self.instances
            ]
        )

    def material_table(self) -> MaterialTable:
        return MaterialTable.from_materials(self.materials)


def _uv_mapping_attrs(flat: FlatScene):
    """Per-triangle texel density (uv area / world area, for mip selection)
    and uv-aligned tangent frame (for normal mapping) — the footprint/tangent
    data the reference derives in rt/hit.glsl:95+ and rt/footprint.glsl."""
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
    # standard uv-basis bitangent B = (e2*u1 - e1*u2)/det: verified
    # numerically to give sign(dot(cross(n, T), B)) == the reference's
    # bitangent_l sign (rt/hit.glsl:118) on random triangles — a negated
    # B here would flip the green channel of every normal map
    bitangent = (flat.e2 * duv1[:, 0:1] - flat.e1 * duv2[:, 0:1]) * r[:, None]
    handed = np.where(
        np.sum(np.cross(gn, tangent) * bitangent, axis=-1) >= 0.0, 1.0, -1.0
    ).astype(np.float32)
    return density, np.concatenate([tangent.astype(np.float32), handed[:, None]], axis=1)
