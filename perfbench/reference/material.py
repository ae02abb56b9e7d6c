"""BaseMaterial — Disney-style layered material parameters.

Mirrors the reference ``BaseMaterial`` struct
(rendering/bsdfs/base_material.h.glsl:13-41) and the VkrMaterial ->
BaseMaterial translation (librender/scene.cpp:820-975):
- base_color defaults to white and is overridden by the emitter base color
  for emissive materials,
- roughness/metallic default to the reference's default specular texture
  texel (255,127,0) -> roughness 127/255, metallic 0,
- specular_transmission + ior from the material params; ONESIDED set for
  transmissive materials unless tagged two-sided.

Stored as a struct-of-arrays table so the whole material set is one pytree
of device arrays indexed by material id inside jitted shading code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

BASE_MATERIAL_NOALPHA = 0x01
BASE_MATERIAL_ONESIDED = 0x02
BASE_MATERIAL_VOLUME = 0x04
BASE_MATERIAL_EXTENDED = 0x08
BASE_MATERIAL_NEURAL = 0x10
# repo-internal: the THIN_TRANSMISSION_HIT hit-group assignment
# (vulkan/CMakeLists.txt:38-39) expressed as a material flag — on TPU the
# hit "shader" is selected data-driven rather than via the SBT
BASE_MATERIAL_THIN = 0x20


@dataclass
class BaseMaterial:
    base_color: np.ndarray = field(default_factory=lambda: np.full(3, 0.9, np.float32))
    normal_map: int = -1
    flags: int = 0
    roughness: float = 1.0
    specular: float = 0.5
    metallic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.1
    ior: float = 1.5
    specular_transmission: float = 0.0
    anisotropy: float = 0.0
    specular_tint: float = 0.0
    transmission_color: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    emission_intensity: float = 0.0
    # texture slots (indices into the scene texture table, -1 = constant)
    base_color_tex: int = -1
    specular_tex: int = -1  # .g = roughness, .b = metallic (scene.cpp:946-951)


@dataclass
class MaterialTable:
    """SoA arrays over all materials; uploaded as one pytree."""

    base_color: np.ndarray  # (M, 3) f32
    roughness: np.ndarray  # (M,) f32
    specular: np.ndarray  # (M,) f32
    metallic: np.ndarray  # (M,) f32
    ior: np.ndarray  # (M,) f32
    specular_transmission: np.ndarray  # (M,) f32
    transmission_color: np.ndarray  # (M, 3) f32
    emission_intensity: np.ndarray  # (M,) f32
    flags: np.ndarray  # (M,) i32
    sheen: np.ndarray  # (M,) f32
    sheen_tint: np.ndarray  # (M,) f32
    clearcoat: np.ndarray  # (M,) f32
    clearcoat_gloss: np.ndarray  # (M,) f32
    anisotropy: np.ndarray  # (M,) f32
    specular_tint: np.ndarray  # (M,) f32
    base_color_tex: np.ndarray  # (M,) i32
    normal_tex: np.ndarray  # (M,) i32
    specular_tex: np.ndarray  # (M,) i32

    @property
    def count(self) -> int:
        return len(self.roughness)

    @staticmethod
    def from_materials(mats: List[BaseMaterial]) -> "MaterialTable":
        if not mats:
            mats = [BaseMaterial()]
        return MaterialTable(
            base_color=np.stack([m.base_color for m in mats]).astype(np.float32),
            roughness=np.array([m.roughness for m in mats], np.float32),
            specular=np.array([m.specular for m in mats], np.float32),
            metallic=np.array([m.metallic for m in mats], np.float32),
            ior=np.array([m.ior for m in mats], np.float32),
            specular_transmission=np.array(
                [m.specular_transmission for m in mats], np.float32
            ),
            transmission_color=np.stack(
                [m.transmission_color for m in mats]
            ).astype(np.float32),
            emission_intensity=np.array(
                [m.emission_intensity for m in mats], np.float32
            ),
            flags=np.array([m.flags for m in mats], np.int32),
            sheen=np.array([m.sheen for m in mats], np.float32),
            sheen_tint=np.array([m.sheen_tint for m in mats], np.float32),
            clearcoat=np.array([m.clearcoat for m in mats], np.float32),
            clearcoat_gloss=np.array([m.clearcoat_gloss for m in mats], np.float32),
            anisotropy=np.array([m.anisotropy for m in mats], np.float32),
            specular_tint=np.array([m.specular_tint for m in mats], np.float32),
            base_color_tex=np.array([m.base_color_tex for m in mats], np.int32),
            normal_tex=np.array([m.normal_map for m in mats], np.int32),
            specular_tex=np.array([m.specular_tex for m in mats], np.int32),
        )


def translate_vkr_material(vkrm, base_color_tex=-1, normal_tex=-1, specular_tex=-1):
    """VkrMaterial -> BaseMaterial (librender/scene.cpp:825-975)."""
    m = BaseMaterial()
    # untextured base color defaults to white (scene.cpp:886-896); constant
    # color param overrides (our BaseColor.txt extension)
    if getattr(vkrm, "base_color", None) is not None:
        m.base_color = np.asarray(vkrm.base_color, np.float32)
    else:
        m.base_color = np.ones(3, np.float32)
    m.base_color_tex = base_color_tex
    m.normal_map = normal_tex
    m.specular_tex = specular_tex
    if specular_tex < 0:
        # default specular texel (255,127,0): roughness .g, metallic .b
        m.roughness = 127.0 / 255.0
        m.metallic = 0.0
    if base_color_tex < 0:
        m.flags |= BASE_MATERIAL_NOALPHA
    if vkrm.emission_intensity > 0:
        if np.any(np.asarray(vkrm.emitter_base_color) != 0.0):
            m.base_color = np.asarray(vkrm.emitter_base_color, np.float32)
        m.emission_intensity = float(vkrm.emission_intensity)
    m.specular_transmission = float(vkrm.specular_transmission)
    ext = (vkrm.extended_name or "").lower()
    if m.specular_transmission and "twosided" not in ext and "doublesided" not in ext:
        m.flags |= BASE_MATERIAL_ONESIDED
    m.ior = float(vkrm.ior_eta)
    return m
