"""Megakernel path-tracing integrator (PyTorch).

Port of the slice of the reference's ``ops/integrator.py`` that the
cornell main path runs: the scene tables (:123-213), the shading and light
functions (:253-909), the per-bounce ``visit_hit``/``scatter_tail``
closures (:1011-1485), ``trace_paths`` with its bounce loop unrolled and
the whole-wave early out (:1486-1729), the camera (:1730-1870), the
swizzle tables (:1969-2065) and the pass body with its in-place
blend (:2067-2151). Semantics, RNG draw order and expression order follow the
reference line by line; see its module docstring for the GLSL sources.

Traversal goes where the reference's ``_closest_hit_dispatch`` and
``occluded_alpha`` send it (integrator.py:485-578, 642-739): the resident
walk K1 (``ops/traverse_resident.py``), or on large resident scenes
(``cfg.kernel_v3``) the flat-cull kernels K2 and K3
(``ops/traverse_flat.py``), with the coherence sort where ``compact``,
``presorted`` and ``sort_shadow`` ask for it; under ``RPTR_TRAVERSAL_V1``
(``cfg.traversal_v1``) the v1 packet walk K8a/K8b (``ops/traverse_v1.py``),
never sorted, merged in the wavefront variant; on streamed scenes
(``cfg.streamed``) the sorted streamed walk K4 for closest hits
(``ops/traverse_stream.py``; with ``stream_closest`` its ordered walk, the
binned rounds of K5 or the multislot K5 launch) and one binned round of K5
with its K4
cleanup for every shadow ray (``ops/traverse_binned.py``); on instanced
scenes (``cfg.two_level``) the two-level walks, K6 (``cfg.tlas_k6``,
``ops/traverse_tlas.py``) or K7 (``cfg.tlas_stream``,
``ops/traverse_tlas_stream.py``), whose hits carry a global shading row and
an instance: ``visit_hit`` takes the edges to world space by the instance's
A, the shading normal by A^-T, and offsets the material id
(integrator.py:1158-1169, 1182-1184). Each launches its CUDA kernel on CUDA
tensors and runs its plain version on CPU tensors. Attribute tables are in
BVH-row order on the resident routes, so a hit's row is its attribute
index, in source-triangle order on the streamed route, whose hits carry
source triangle ids, and in object-space mesh order on the two-level
routes; a fetch is plain indexing (the reference's one-hot MXU fetch is
TPU-only).

Textured scenes (``cfg.has_textures``) sample the atlas
(``ops/texture_atlas.py``) for base colour, specular/roughness and normal
maps at a mip chosen from the ray-differential footprint that the carry
transports across bounces (integrator.py:1205-1318, 1432-1443); with
``cfg.alpha_test`` closest hits and shadow rays re-trace past alpha-cut
texels (``closest_hit_alpha``, ``occluded_alpha``; integrator.py:446-780).
The ``rptr.shade`` stage of a bounce goes through ``ops/shade.py``: on the
card two fused kernels where ``shade.fused`` admits the configuration, else
their plain versions (always on the CPU). The scene tables' column layout,
the footprint transforms, the sky term and the deferred shadow queue that
both modules use live in ``ops/shade_common.py``.
The ``PT_WAVEFRONT`` variant (``cfg.wavefront``) defers each bounce's NEE
shadow ray to the next bounce, where on the K1 route both queues go to the
card as one merged launch (integrator.py:1021-1115, 1380-1400). The RNG
draws go through ``ops/pointsets.py`` at the reference's path-space dims
with the scene's tables (``DeviceScene.rng``), and ``cfg.compact_lanes``
runs the bounces past 0 on a coherence-sorted, live-first carry's
smallest covering prefix (``_compacted_bounces``; integrator.py:1606-1717).

Binned RIS light selection (``cfg.use_light_bins``, ``ops/nee.py``),
thin-lens depth of field (``cfg.enable_dof``, ``camera_setup``) and the
``DEBUG_MODE_*`` counters (``cfg.debug_mode``: any-hit evaluations over the
path or at primary visibility, or bounces; ``trace_paths`` returns the count
as its 4th output) follow the reference (integrator.py:1036-1130,
1342-1480, 1604-1610, 1722-1726, 1840-1867); ``render_ray_stats_host``
and ``render_debug_host`` render the one-sample count images of the
reference's ``make_ray_stats_fn`` and ``make_debug_fn`` (:2154-2238).
``render_tile_host`` renders the image-domain path's frame on fresh chunks
(:2259-2305), ``render_tile`` a pixel tile of the frame, the unit of the
multi-device renders (:1876-1916; ``parallel/render_sharded.py``), and
``image_to_planes`` re-swizzles an image history into the planar layout
(:2036-2042).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.models.material import (
    BASE_MATERIAL_NOALPHA,
)
from realtimepathtracingresearchframework_tpu_torch.models.sky import (
    SkyParams,
)
from realtimepathtracingresearchframework_tpu_torch.ops import nee as nee_mod
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
from realtimepathtracingresearchframework_tpu_torch.ops import shade as shade_mod
from realtimepathtracingresearchframework_tpu_torch.ops.shade_common import (
    ATTR_W,
    MAT_W,
    RAY_EPSILON,
    Footprint,
    PendingNEE,
    _A_MID,
    _A_TAN,
    _A_UV0,
    _A_UV1,
    _A_UV2,
    _M_BCTEX,
    _M_FLAGS,
    _dpdxy_to_footprint_v,
    _fetch_cols_ranges,
    empty_pend,
)
from realtimepathtracingresearchframework_tpu_torch.ops import vec3 as v3
from realtimepathtracingresearchframework_tpu_torch.ops.bsdf_gltf import (
    GLTFMaterial,
    gltf_bsdf_v,
    gltf_wpdf_v,
)
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu_torch.ops.rng import M32
from realtimepathtracingresearchframework_tpu_torch.ops.texture_atlas import (
    TextureAtlas,
    sample_atlas,
)
from realtimepathtracingresearchframework_tpu_torch.ops.tlas import TwoLevelHit
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    Hit,
    ResidentBVH,
)
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_binned
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_stream
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_tlas_stream,
)
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_v1
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    closest_and_occluded_resident,
    closest_hit_resident,
    coherence_key,
    inverse_permutation,
    occluded_resident,
    pack_resident,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3
from realtimepathtracingresearchframework_tpu_torch.utils.profiling import (
    count_shaded,
    host_read,
    span,
)

RAYS_PER_PASS = 524288  # rays in flight per pass (integrator.py:71)


class DeviceScene(NamedTuple):
    """Everything the integrator reads, on one device."""

    bvh: ResidentBVH  # traverse_flat.FlatBVH when cfg.kernel_v3,
    # traverse_v1.V1BVH when cfg.traversal_v1,
    # traverse_stream.StreamedBVHBuffers when cfg.streamed, None when
    # cfg.two_level
    attr_packed: torch.Tensor  # (ATTR_W, R) f32 per-row (or per-tri) attributes
    mat_packed: torch.Tensor  # (MAT_W, M) f32 material rows
    lights: nee_mod.TriLightBuffers
    sky: SkyParams
    tlas: object = None  # tlas.TwoLevelBuffers when cfg.two_level: the
    # instance tables visit_hit reads (and the nested walk's oracle)
    tlas_k6: object = None  # traverse_tlas.TlasBuffers when cfg.tlas_k6
    tlas_stream: object = None  # (TlasStreamStatic, TlasStreamFrame) when
    # cfg.tlas_stream
    atlas: Optional[TextureAtlas] = None  # the scene's textures (a 1-texel
    # dummy without): read only when cfg.has_textures
    rng: Optional[pointsets.RngBuffers] = None  # the RNG variant's tables
    # (pointsets.build_rng_buffers); the LCG reads none


def pack_attr_table(tris, shading) -> torch.Tensor:
    """Per-triangle shading attributes -> (ATTR_W, T) f32 column table.
    ``tris`` has e1, e2; ``shading`` has n0-n2, uv0-uv2, tangent,
    texel_density, material_id (numpy arrays, e.g. a FlatScene)."""
    cols = [
        tris.e1, tris.e2, shading.n0, shading.n1, shading.n2,
        shading.uv0, shading.uv1, shading.uv2, shading.tangent,
        np.asarray(shading.texel_density)[:, None],
        np.asarray(shading.material_id, np.float32)[:, None],
    ]
    packed = np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)
    packed = np.pad(packed, ((0, 0), (0, ATTR_W - packed.shape[1])))
    return torch.from_numpy(np.ascontiguousarray(packed.T))


def pack_material_table(mats) -> torch.Tensor:
    """MaterialTable (numpy) -> (MAT_W, M) f32 column table."""

    def as_f32(a):
        return np.asarray(a, np.float32)[:, None]

    cols = [
        np.asarray(mats.base_color, np.float32),
        as_f32(mats.roughness),
        as_f32(mats.specular),
        as_f32(mats.metallic),
        as_f32(mats.ior),
        as_f32(mats.specular_transmission),
        as_f32(mats.emission_intensity),
        as_f32(mats.flags),
        as_f32(mats.base_color_tex),
        as_f32(mats.specular_tex),
        as_f32(mats.normal_tex),
        as_f32(mats.clearcoat_gloss),
    ]
    packed = np.concatenate(cols, axis=1)
    packed = np.pad(packed, ((0, 0), (0, MAT_W - packed.shape[1])))
    return torch.from_numpy(np.ascontiguousarray(packed.T))


_SKY_FIELDS = SkyParams._fields


def device_scene_from_numpy(arrays: dict, device) -> DeviceScene:
    """The reference's DeviceScene arrays (numpy) -> the port's DeviceScene.

    Keys: ``bvh.nodes`` (M, 8) f32 with the skip and leaf-row links as
    int32 bit patterns in columns 6-7 (the ``ThreadedBVH`` layout),
    ``bvh.tri_rows`` (R, >=9), ``bvh.row_tri`` (R,), ``bvh.leaf_size``;
    ``attr_packed`` (ATTR_W, T) and ``mat_packed`` (MAT_W, M);
    ``lights.v0``/``v1``/``v2``/``radiance`` (L, 3); ``sky.<field>`` for
    every SkyParams field. ``row_attrs`` (default False) says whether
    ``attr_packed`` is already in BVH-row order; if not it is reordered,
    since the port indexes attributes by row."""
    from types import SimpleNamespace

    tb = SimpleNamespace(
        nodes=np.array(arrays["bvh.nodes"], np.float32),
        tri_rows=np.array(arrays["bvh.tri_rows"], np.float32),
        row_tri=np.array(arrays["bvh.row_tri"], np.int32),
        leaf_size=int(arrays["bvh.leaf_size"]),
    )
    attr = np.asarray(arrays["attr_packed"], np.float32)
    if not arrays.get("row_attrs", False):
        attr = attr[:, np.clip(tb.row_tri, 0, attr.shape[1] - 1)]
    sky = SkyParams(**{
        f: torch.from_numpy(np.array(arrays[f"sky.{f}"], np.float32)).to(device)
        for f in _SKY_FIELDS
    })
    return DeviceScene(
        bvh=pack_resident(tb, device),
        attr_packed=torch.from_numpy(np.ascontiguousarray(attr)).to(device),
        mat_packed=torch.from_numpy(
            np.array(arrays["mat_packed"], np.float32)
        ).to(device),
        lights=nee_mod.light_buffers(
            arrays["lights.v0"], arrays["lights.v1"], arrays["lights.v2"],
            arrays["lights.radiance"], device,
        ),
        sky=sky,
    )


class ViewBuffers(NamedTuple):
    """ViewParams analogue (vulkan/gpu_params.glsl:61-87): (3,) f32."""

    cam_pos: torch.Tensor
    cam_du: torch.Tensor
    cam_dv: torch.Tensor
    cam_dir_top_left: torch.Tensor


class IntegratorConfig(NamedTuple):
    """Static configuration — the reference's IntegratorConfig subset the
    port runs."""

    max_path_depth: int = 9
    light_bin_size: int = 16
    use_light_bins: bool = False
    num_lights: int = 0
    enable_sun_sky: bool = True
    rng_variant: int = 0
    has_transmission: bool = True
    thin_transmission: bool = False
    has_textures: bool = False
    alpha_test: bool = False
    enable_dof: bool = False
    two_level: bool = False  # instanced scene: K6 or K7, world attributes
    tlas_k6: bool = False  # two-level walk through K6 (within its caps)
    tlas_stream: bool = False  # two-level walk through K7
    streamed: bool = False
    compact: bool = False  # coherence sort before each dispatch past bounce 0
    compact_lanes: bool = False  # carry compaction of the bounce loop
    wavefront: bool = False
    debug_mode: int = 0  # DEBUG_MODE_* heatmap (0: off; see DEBUG_MODES)
    kernel_v3: bool = False  # K2/K3 flat cull instead of the K1 walk
    traversal_v1: bool = False  # the v1 walk K8a/K8b (RPTR_TRAVERSAL_V1)
    kernel_v4: bool = False  # sorted queues on K3 instead of K2
    # streamed closest hits: "sorted" (K4), "ordered" (K4 front to back;
    # K6's ordered instance walk on the K6 route), "binned" (K5 rounds) or
    # "multislot" (one K5 launch over every overlapped subtree)
    stream_closest: str = "sorted"
    aniso_taps: int = 0  # anisotropic texture taps (0: isotropic mip)


# DEBUG_MODE_* values (backend/params.py; render_params.glsl.h:63-70)
_DBG_ANY_FULL = 1  # any-hit evaluations over the full path
_DBG_ANY_PRIMARY = 2  # any-hit evaluations of primary visibility
_DBG_BOUNCE = 3  # bounces
DEBUG_MODES = (0, _DBG_ANY_FULL, _DBG_ANY_PRIMARY, _DBG_BOUNCE)
STREAM_CLOSEST = ("sorted", "ordered", "binned", "multislot")


def check_stream_closest(strategy: str) -> None:
    """The streamed closest-hit strategies of the reference
    (``IntegratorConfig.stream_closest``): a typo raises ``ValueError``."""
    if strategy not in STREAM_CLOSEST:
        raise ValueError(
            f"stream_closest={strategy!r}: expected one of {STREAM_CLOSEST}")


def check_supported(cfg: IntegratorConfig) -> None:
    """Raise ``ValueError`` for a debug mode that is not one of
    ``DEBUG_MODES``."""
    if cfg.debug_mode not in DEBUG_MODES:
        raise ValueError(
            f"debug_mode={cfg.debug_mode!r}: expected one of {DEBUG_MODES}")


class FrameParams(NamedTuple):
    """Per-frame params (RenderParams subset the slice reads)."""

    rr_path_depth: int = 2
    glossy_only_mode: int = 0
    sample_offset: int = 0  # accumulation frame offset (u32)
    shot_offset: int = 0  # frame_offset randomization (u32)
    pixel_radius: float = 1.0  # mip footprint scale (camera_footprint0)
    bump_scale: float = 1.0  # normal-map strength (SceneConfig.bump_scale)
    aperture_radius: float = 0.0  # thin-lens DoF (render_params.glsl.h)
    focus_distance: float = 1.0


class NEECandidate(NamedTuple):
    """An unresolved NEE sample: contribution + its occlusion ray."""

    contrib: Vec3  # MIS-weighted, NOT throughput-scaled
    dir: Vec3
    eps: torch.Tensor  # shadow t_min
    shadow_tmax: torch.Tensor
    traced: torch.Tensor  # bool: needs the visibility ray
    uncond: torch.Tensor  # bool: visible without tracing
    dropped: torch.Tensor  # bool: a candidate dropped for a non-finite
    # contribution (not in the reference, which keeps the NaN)


# NEE samples of active lanes dropped for a non-finite contribution in this
# process: one device scalar per device, summed without a host read; read
# with nee_dropped(), reset with reset_nee_dropped()
_nee_dropped = {}


def reset_nee_dropped() -> None:
    _nee_dropped.clear()


def nee_dropped() -> int:
    """Dropped NEE samples since the last reset (synchronises)."""
    return sum(int(n) for n in _nee_dropped.values())


def _count_nee_dropped(mask) -> None:
    _nee_dropped[mask.device] = _nee_dropped.get(mask.device, 0) + mask.sum()


def _nee_candidate(ds: DeviceScene, cfg: IntegratorConfig, hit_p: Vec3,
                   hit_n: Vec3, hit_gn: Vec3, mat: GLTFMaterial, w_o: Vec3,
                   dir_sample, sel_sample, total_t) -> NEECandidate:
    """sample_direct_light minus the visibility trace (mc/nee.glsl:32-90)."""
    sky = ds.sky
    sun_w = sky.sun_radiance[3]

    # --- sun branch
    sun_sel = sel_sample[0] <= sun_w
    sun_dir = nee_mod.sample_sun_dir_v(
        sky.sun_dir, sky.sun_cos_angle, dir_sample[0], dir_sample[1]
    )
    sun_pdf = nee_mod.sun_dir_pdf(sky.sun_cos_angle)
    sr = sky.sun_radiance
    sun_scale = 1.0 / (torch.clamp(sun_w, min=1e-9) * sun_pdf)
    sun_illum = Vec3(sr[0] * sun_scale, sr[1] * sun_scale, sr[2] * sun_scale)
    sun_light_pdf = sun_pdf * sun_w

    if cfg.num_lights > 0:
        # --- area branch (renormalized selector)
        sel2 = (
            torch.clamp(
                (sel_sample[0] - sun_w) / torch.clamp(1.0 - sun_w, min=1e-9),
                0.0, 1.0,
            ),
            sel_sample[1],
        )
        ls = nee_mod.sample_tri_lights_v(
            ds.lights, hit_p, hit_n, dir_sample, sel2,
            cfg.light_bin_size, cfg.use_light_bins,
        )
        inv_area_w = 1.0 / torch.clamp(1.0 - sun_w, min=1e-9)
        tri_illum = ls.illum * inv_area_w
        tri_light_pdf = ls.pdf * (1.0 - sun_w)
        tri_mis_pdf = ls.mis_wpdf * (1.0 - sun_w)

        illum = v3.where(sun_sel, sun_illum, tri_illum)
        light_dir = v3.where(sun_sel, sun_dir, ls.dir)
        light_dist = torch.where(sun_sel, 2.0e16, ls.dist)
        light_pdf = torch.where(sun_sel, sun_light_pdf, tri_light_pdf)
        mis_pdf = torch.where(sun_sel, sun_light_pdf, tri_mis_pdf)
    else:
        zero = torch.zeros_like(hit_p.x)
        illum = sun_illum + v3.splat(zero)
        light_dir = sun_dir
        light_dist = zero + 2.0e16
        light_pdf = zero + sun_light_pdf
        mis_pdf = light_pdf

    # strict normals (nee.glsl:73-75)
    strict = v3.dot(light_dir, hit_gn) * v3.dot(light_dir, hit_n) > 0.0
    candidate = (light_pdf > 0.0) & strict

    # visibility segment with epsilon (pt_megakernel.glsl:216-224)
    eps = (v3.length(hit_p) + total_t) * RAY_EPSILON
    seg_ok = light_dist - 2.0 * eps > 0.0
    shadow_tmax = torch.maximum(light_dist - eps, eps)
    shadow_tmax_eff = torch.where(candidate & seg_ok, shadow_tmax, eps)

    bsdf_pdf = gltf_wpdf_v(mat, hit_n, w_o, light_dir, cfg.has_transmission,
                           cfg.thin_transmission)
    f = gltf_bsdf_v(mat, hit_n, w_o, light_dir, cfg.has_transmission,
                    cfg.thin_transmission)
    w = nee_mod.nee_mis_heuristic(1.0, mis_pdf, 1.0, bsdf_pdf)
    contrib = illum * f * (w * v3.dot(light_dir, hit_n).abs())
    # a light triangle sampled from a point nearly in its plane (a path
    # vertex on an emitter) can overflow the sample's distance and MIS pdf,
    # and the reference's contribution is then NaN (inf / inf in the
    # balance heuristic); such a sample is dropped and counted, or it would
    # poison the pixel's accumulation (seen on an H100 on the village's
    # window lights; tests/test_torch_shading.py replays that lane)
    finite = (torch.isfinite(contrib.x) & torch.isfinite(contrib.y)
              & torch.isfinite(contrib.z))
    base_ok = candidate & (bsdf_pdf >= 0.0)
    dropped = base_ok & ~finite
    base_ok = base_ok & finite
    zero3 = v3.splat(torch.zeros_like(w))
    return NEECandidate(
        contrib=v3.where(base_ok, contrib, zero3),
        dir=light_dir,
        eps=eps,
        shadow_tmax=shadow_tmax_eff,
        traced=base_ok & seg_ok,  # apply iff the shadow ray is clear
        uncond=base_ok & ~seg_ok,  # degenerate segment: always visible
        dropped=dropped,
    )


def _closest_hit_dispatch(ds: DeviceScene, cfg: IntegratorConfig, ro: Vec3,
                          rd: Vec3, t_min, t_max, compact: bool = False,
                          presorted: bool = False):
    """The closest-hit route of integrator.py:485-578 (resident scenes).
    ``presorted``: the caller already coherence-sorted the lanes (the
    wavefront executor); skip the sort but keep the sorted-queue policy:
    K3 at block 1024 in 8 groups (``cfg.kernel_v4``), else K2 at block 1024.
    Unsorted queues (camera primaries) take K2 at block 512. Streamed
    scenes (integrator.py:516-535) take the coherence-sorted K4 walk, its
    ordered walk with ``stream_closest="ordered"``, the binned rounds of
    K5 with ``"binned"`` or the multislot K5 launch with ``"multislot"``;
    their hits carry source triangle ids. Instanced scenes
    (integrator.py:491-515) take K6 (its ordered instance walk with
    ``"ordered"``), or K7, coherence-sorted only on a ``compact`` queue
    that the caller has not sorted; their hits carry global shading rows
    and instances. The v1 route (``cfg.traversal_v1``) takes K8, which
    never sorts (integrator.py:572)."""
    if cfg.two_level:
        if cfg.tlas_k6:
            return traverse_tlas.closest_hit_tlas(
                ds.tlas_k6, ro, rd, t_min, t_max,
                ordered=cfg.stream_closest == "ordered")
        assert cfg.tlas_stream, "a two-level scene runs on K6 or K7"
        static, frame = ds.tlas_stream
        return traverse_tlas_stream.closest_hit_tlas_stream(
            static, frame, ro, rd, t_min, t_max,
            sort=compact and not presorted)
    if cfg.streamed:
        check_stream_closest(cfg.stream_closest)
        if cfg.stream_closest == "binned":
            return traverse_binned.closest_hit_binned(ds.bvh, ro, rd, t_min,
                                                      t_max)
        if cfg.stream_closest == "multislot":
            return traverse_binned.closest_hit_binned_all(ds.bvh, ro, rd,
                                                          t_min, t_max)
        return traverse_stream.closest_hit_streamed(
            ds.bvh, ro, rd, t_min, t_max, sort=True,
            ordered=cfg.stream_closest == "ordered")
    if cfg.traversal_v1:
        return traverse_v1.closest_hit_v1(ds.bvh, ro, rd, t_min, t_max,
                                          map_tri=False, compact=compact)
    if cfg.kernel_v3:
        if (compact or presorted) and cfg.kernel_v4:
            return traverse_flat.closest_hit_precull(
                ds.bvh, ro, rd, t_min, t_max, block=1024, groups=8,
                compact=compact,
            )
        return traverse_flat.closest_hit_flat(
            ds.bvh, ro, rd, t_min, t_max,
            block=1024 if (compact or presorted) else 512, compact=compact,
        )
    return closest_hit_resident(ds.bvh, ro, rd, t_min, t_max, compact=compact)


def _occluded_dispatch(ds: DeviceScene, cfg: IntegratorConfig, ro: Vec3,
                       rd: Vec3, t_min, t_max, compact: bool = False,
                       sort_shadow: bool = False):
    """The occlusion route of occluded_alpha (integrator.py:642-739,
    scenes without alpha cutouts). ``sort_shadow`` coherence-sorts this
    queue by its own origins (fresh hit points past bounce 0): K3 at block
    1024 in 8 groups (``cfg.kernel_v4``), else K2 sorted. Streamed scenes
    take one binned round of K5 and its K4 cleanup (integrator.py:684-696);
    instanced scenes K6, or K7 sorted by ``sort_shadow``
    (integrator.py:660-683); the v1 route K8 (integrator.py:728)."""
    if cfg.two_level:
        if cfg.tlas_k6:
            return traverse_tlas.occluded_tlas(ds.tlas_k6, ro, rd, t_min, t_max)
        assert cfg.tlas_stream, "a two-level scene runs on K6 or K7"
        static, frame = ds.tlas_stream
        return traverse_tlas_stream.occluded_tlas_stream(
            static, frame, ro, rd, t_min, t_max, sort=sort_shadow)
    if cfg.streamed:
        return traverse_binned.occluded_binned(ds.bvh, ro, rd, t_min, t_max,
                                               rounds=1)
    if cfg.traversal_v1:
        return traverse_v1.occluded_v1(ds.bvh, ro, rd, t_min, t_max,
                                       compact=compact)
    if cfg.kernel_v3:
        if sort_shadow and cfg.kernel_v4:
            return traverse_flat.occluded_precull(
                ds.bvh, ro, rd, t_min, t_max, block=1024, groups=8,
                compact=True,
            )
        return traverse_flat.occluded_flat(
            ds.bvh, ro, rd, t_min, t_max, compact=sort_shadow
        )
    return occluded_resident(ds.bvh, ro, rd, t_min, t_max, compact=compact)


MAX_ALPHA_HOPS = 4  # candidate-hit re-trace budget (generate_candidate_hit)
ALPHA_CUTOFF = 0.5  # punch-through threshold
# alpha-test re-trace dispatches in this process (reset with
# reset_alpha_counts); the host reads of "is any lane still cut", one before
# each possible hop, count as profiling.host_syncs["alpha_cut"]
alpha_hops = 0


def reset_alpha_counts() -> None:
    global alpha_hops
    alpha_hops = 0


def _any_cut(mask) -> bool:
    """One host read: does any lane still sit on a cut texel?"""
    return host_read("alpha_cut", mask.any())


def _hit_alpha_cut(ds: DeviceScene, tri, u, v, inst=None):
    """(cut, evaluated): True where the hit texel is alpha-cut, the any-hit
    alpha test of ``generate_candidate_hit`` (integrator.py:456-482), and
    where an any-hit evaluation happened (a hit on an alpha-testable
    material: the DEBUG_MODE_ANY_HIT_* event, any_hit.glsl:43-59). Samples
    mip 0 of the base-colour texture; ``inst`` (two-level hits) applies the
    per-instance material offset."""
    c = _fetch_cols_ranges(ds.attr_packed, torch.clamp(tri, min=0).to(torch.int64),
                           [(_A_UV0, _A_TAN), (_A_MID, _A_MID + 1)])
    b0 = 1.0 - u - v
    uv = torch.stack([
        c[_A_UV0] * b0 + c[_A_UV1] * u + c[_A_UV2] * v,
        c[_A_UV0 + 1] * b0 + c[_A_UV1 + 1] * u + c[_A_UV2 + 1] * v,
    ], dim=-1)
    mid = c[_A_MID].to(torch.int64)
    if inst is not None:
        mid = mid + ds.tlas.inst_mat_offset[torch.clamp(inst, min=0).to(torch.int64)]
    mc = _fetch_cols_ranges(ds.mat_packed, mid, [(_M_FLAGS, _M_BCTEX + 1)])
    bc_tid = mc[_M_BCTEX].to(torch.int32)
    flags = mc[_M_FLAGS].to(torch.int32)
    a = sample_atlas(ds.atlas, bc_tid, uv, torch.zeros_like(u))[:, 3]
    evaluated = (tri >= 0) & (bc_tid >= 0) & ((flags & BASE_MATERIAL_NOALPHA) == 0)
    return evaluated & (a < ALPHA_CUTOFF), evaluated


def _alpha_eps(t):
    """Re-trace offset past a cut hit (integrator.py:608), in its order."""
    return t.abs() * 1e-4 + 1e-5


def closest_hit_alpha(ds: DeviceScene, cfg: IntegratorConfig, ro: Vec3,
                      rd: Vec3, t_min, t_max, compact: bool = False,
                      presorted: bool = False, count_evals: bool = False):
    """Closest hit honouring alpha-cutout textures (integrator.py:581-639):
    re-traces past cut texels up to MAX_ALPHA_HOPS, each hop one dispatch
    of the route over every lane (settled lanes trace an empty segment).
    The loop ends early once no lane is cut, as the reference's
    ``while_loop`` does: one host read per hop. A lane still cut after the
    last hop counts as opaque (:632). Plain ``_closest_hit_dispatch``
    unless ``cfg.alpha_test``. With ``count_evals`` returns (hit, the
    per-lane any-hit evaluation count, int32)."""
    global alpha_hops
    hit = _closest_hit_dispatch(ds, cfg, ro, rd, t_min, t_max, compact=compact,
                                presorted=presorted)
    if not (cfg.alpha_test and cfg.has_textures):
        return (hit, torch.zeros_like(hit.tri)) if count_evals else hit
    inst = hit.inst if cfg.two_level else None
    t, tri, u, v = hit.t, hit.tri, hit.u, hit.v
    with span("rptr.shade"):
        cut, evaluated = _hit_alpha_cut(ds, tri, u, v, inst)
        evals = evaluated.to(torch.int32)
    for _ in range(MAX_ALPHA_HOPS):
        if not _any_cut(cut):
            break
        alpha_hops += 1
        eps = _alpha_eps(t)
        h = _closest_hit_dispatch(
            ds, cfg, ro, rd, torch.where(cut, t + eps, t_min),
            torch.where(cut, t_max, 0.0),  # settled lanes trace nothing
            compact=True)
        t = torch.where(cut, h.t, t)
        tri = torch.where(cut, h.tri, tri)
        u = torch.where(cut, h.u, u)
        v = torch.where(cut, h.v, v)
        if cfg.two_level:
            inst = torch.where(cut, h.inst, inst)
        with span("rptr.shade"):
            new_cut, evaluated = _hit_alpha_cut(ds, tri, u, v, inst)
            evals = evals + (cut & evaluated).to(torch.int32)
            cut = cut & new_cut
    if cfg.two_level:
        hit = TwoLevelHit(t=t, tri=tri, u=u, v=v, inst=inst)
    else:
        hit = Hit(t=t, tri=tri, u=u, v=v)
    return (hit, evals) if count_evals else hit


def occluded_alpha(ds: DeviceScene, cfg: IntegratorConfig, ro: Vec3, rd: Vec3,
                   t_min, t_max, compact: bool = False,
                   sort_shadow: bool = False, count_evals: bool = False):
    """Shadow-ray visibility honouring alpha cutouts (integrator.py:
    642-780): walks candidate closest hits until a solid blocker or the
    segment's end, one dispatch per hop, ending early as
    ``closest_hit_alpha`` does. A lane still inside cut geometry after the
    last hop counts as blocked (:776-777). Plain ``_occluded_dispatch``
    unless ``cfg.alpha_test``. With ``count_evals`` returns (blocked, the
    per-lane any-hit evaluation count)."""
    global alpha_hops
    if not (cfg.alpha_test and cfg.has_textures):
        blocked = _occluded_dispatch(ds, cfg, ro, rd, t_min, t_max,
                                     compact=compact, sort_shadow=sort_shadow)
        return (blocked, torch.zeros(blocked.shape, dtype=torch.int32,
                                     device=blocked.device)
                ) if count_evals else blocked
    hit = _closest_hit_dispatch(ds, cfg, ro, rd, t_min, t_max)
    with span("rptr.shade"):
        in_seg = (hit.tri >= 0) & (hit.t < t_max)
        cut, evaluated = _hit_alpha_cut(ds, hit.tri, hit.u, hit.v,
                                        hit.inst if cfg.two_level else None)
        evals = (in_seg & evaluated).to(torch.int32)
        blocked = in_seg & ~cut
        live = in_seg & cut
    t = hit.t
    for _ in range(MAX_ALPHA_HOPS):
        if not _any_cut(live):
            break
        alpha_hops += 1
        eps = _alpha_eps(t)
        h = _closest_hit_dispatch(
            ds, cfg, ro, rd, torch.where(live, t + eps, t_min),
            torch.where(live, t_max, 0.0), compact=True)
        with span("rptr.shade"):
            in_seg = (h.tri >= 0) & (h.t < t_max) & live
            cut, evaluated = _hit_alpha_cut(ds, h.tri, h.u, h.v,
                                            h.inst if cfg.two_level else None)
            evals = evals + (live & evaluated).to(torch.int32)
            blocked = blocked | (in_seg & ~cut)
            live = in_seg & cut
        t = torch.where(live, h.t, t)
    blocked = blocked | live
    return (blocked, evals) if count_evals else blocked


def _sample_direct_light(ds: DeviceScene, cfg: IntegratorConfig, hit_p: Vec3,
                         hit_n: Vec3, hit_gn: Vec3, mat: GLTFMaterial,
                         w_o: Vec3, dir_sample, sel_sample, total_t,
                         active, compact: bool = False,
                         sort_shadow: bool = False,
                         count_evals: bool = False):
    """sample_direct_light (mc/nee.glsl:32-90) + immediate visibility ray.

    Lanes outside ``active`` get an empty shadow segment: their result is
    discarded by the caller, so they need not walk the BVH. With
    ``count_evals`` every lane traces its segment, as the reference's does,
    and (contribution, any-hit evaluation count) is returned: the count of
    a lane outside ``active`` is part of the debug image there."""
    cand = _nee_candidate(
        ds, cfg, hit_p, hit_n, hit_gn, mat, w_o, dir_sample, sel_sample,
        total_t,
    )
    _count_nee_dropped(cand.dropped & active)
    tmax = cand.shadow_tmax if count_evals else torch.where(
        active, cand.shadow_tmax, cand.eps)
    with span("rptr.shadow"):
        blocked = occluded_alpha(ds, cfg, hit_p, cand.dir, cand.eps, tmax,
                                 compact=compact, sort_shadow=sort_shadow,
                                 count_evals=count_evals)
    if count_evals:
        blocked, evals = blocked
    visible = (cand.traced & ~blocked) | cand.uncond
    contrib = v3.where(visible, cand.contrib, v3.splat(torch.zeros_like(cand.eps)))
    return (contrib, evals) if count_evals else contrib


class Carry(NamedTuple):
    """Per-lane path state between bounces. ``pend`` is the wavefront
    variant's deferred shadow queue, ``foot`` the texture footprint and
    ``dbg`` the debug modes' any-hit evaluation count (int32); each is None
    when the configuration does not carry it."""

    ro: Vec3
    rd: Vec3
    t_min: torch.Tensor
    illum: Vec3
    throughput: Vec3
    active: torch.Tensor
    prev_pdf: torch.Tensor
    bounce_count: torch.Tensor
    total_t: torch.Tensor
    rng_state: pointsets.RngState
    rays: torch.Tensor  # per-lane traced-ray count (closest + shadow)
    pend: Optional[PendingNEE] = None  # cfg.wavefront
    foot: Optional[Footprint] = None  # cfg.has_textures
    dbg: Optional[torch.Tensor] = None  # cfg.debug_mode: any-hit evaluations


def _map_lanes(fn, tree, *others):
    """``fn`` over matching tensors of same-shaped (nested) tuples; None
    entries stay None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *others)
    return type(tree)(*(_map_lanes(fn, *xs) for xs in zip(tree, *others)))


def _permute_lanes(tree, perm):
    """Index every (N,) tensor of a (nested) tuple of lanes by ``perm``
    (integrator.py:923-958, without its int32 carrier: a gather of float
    tensors is bitwise here)."""
    return _map_lanes(lambda a: a[perm], tree)


def _scene_bounds_of(ds: DeviceScene):
    """(lo, hi) world box of the coherence morton grid (integrator.py:
    961-972): the flat BVH's scene box, the resident root node, or on an
    instanced scene the TLAS root (the reference keeps a degenerate 1-tri
    BVH there; the box only orders lanes, never changes a result)."""
    if ds.tlas is not None:
        root = ds.tlas.tlas_nodes[0]
        return root[0:3], root[3:6]
    lo = getattr(ds.bvh, "scene_lo", None)
    if lo is not None:
        return lo, ds.bvh.scene_hi
    bounds = getattr(ds.bvh, "bounds", None)
    if bounds is None:  # the streamed pack: liveness alone, as there
        return None, None
    return bounds[0, 0:3], bounds[0, 3:6]


def _carry_coherence_key(ro: Vec3, rd: Vec3, live, lo, hi):
    """Lane sort key of carry-level compaction (integrator.py:975-1002):
    the contract of traverse_pallas2._coherence_key2 from the SoA carry."""
    return coherence_key(*ro, *rd, live, lo, hi)


# carry-compaction prefix sizes (integrator.py:1004-1008): lane counts are
# quantized to the traversal block so every prefix dispatches whole blocks
_COMPACT_LANE_QUANTUM = 1024
_COMPACT_MAX_HALVINGS = 5  # smallest prefix = n/32


def _make_bounce_fns(ds: DeviceScene, cfg: IntegratorConfig, fp: FrameParams,
                     t_max0=None):
    """The per-bounce closures (visit_hit + scatter_tail), elementwise
    over the lane axis: any caller may run them on any lane prefix (the
    monolithic ``trace_paths`` and the wavefront executor). ``t_max0``
    (per lane) bounds the primary segment (integrator.py:1047-1052)."""
    count_any = cfg.debug_mode in (_DBG_ANY_FULL, _DBG_ANY_PRIMARY)
    # the rptr.shade stage: its two kernels where they implement the
    # configuration, else its plain version, on the card too
    fused = shade_mod.fused(cfg)
    shade_hit = shade_mod.shade_hit if fused else shade_mod.shade_hit_plain
    shade_scatter = (shade_mod.shade_scatter if fused
                     else shade_mod.shade_scatter_plain)

    def count(dbg, evals, bounce_count):
        """The debug count after this bounce's closest-hit evaluations:
        every one in the full-path mode, the primary rays' in the other
        (integrator.py:1100-1130)."""
        if cfg.debug_mode == _DBG_ANY_FULL:
            return dbg + evals
        return dbg + torch.where(bounce_count == 0, evals, 0)

    def traverse(carry: Carry, compact: bool, presorted: bool):
        """This bounce's closest hits (span ``rptr.closest``); in the
        wavefront variant also the previous bounce's deferred shadow rays
        (``rptr.nee`` > ``rptr.shadow``, or in the closest dispatch where
        one launch takes both queues), whose unblocked contributions go
        into ``illum`` before this bounce's sky and emitter terms
        (integrator.py:1053-1115). Returns (hit, illum, the debug count)."""
        ro, rd, active = carry.ro, carry.rd, carry.active
        dbg = carry.dbg
        alpha = cfg.alpha_test and cfg.has_textures
        with span("rptr.closest"):
            tmax_eff = torch.where(active, T_MAX, 0.0)
            if t_max0 is not None:
                # the bounded primary segment of a ray query
                # (RenderRayQuery.t_max); later bounces are unbounded
                tmax_eff = torch.where(carry.bounce_count == 0,
                                       torch.where(active, t_max0, 0.0),
                                       tmax_eff)
            if not cfg.wavefront:
                hit = closest_hit_alpha(ds, cfg, ro, rd, carry.t_min, tmax_eff,
                                        compact=compact, presorted=presorted,
                                        count_evals=count_any)
                if count_any:
                    hit, evals = hit
                    dbg = count(dbg, evals, carry.bounce_count)
                return hit, carry.illum, dbg
            pend = carry.pend
            ntmax_eff = torch.where(pend.traced, pend.tmax, 0.0)
            blocked = None
            if cfg.streamed and not alpha:
                # K4 for the closest queue, one binned K5 round for the
                # shadows
                hit = _closest_hit_dispatch(ds, cfg, ro, rd, carry.t_min,
                                            tmax_eff)
            elif cfg.traversal_v1 and not alpha:
                # the v1 route: both queues in one merged K8 launch
                # (integrator.py:1070-1080)
                hit, blocked = traverse_v1.closest_and_occluded_v1(
                    ds.bvh, (*ro, *rd), carry.t_min, tmax_eff,
                    (*ro, *pend.dir), pend.tmin, ntmax_eff, map_tri=False,
                    compact=compact)
            elif not (cfg.streamed or cfg.kernel_v3 or cfg.two_level or alpha):
                # the K1 route: both queues in one merged launch
                hit, blocked = closest_and_occluded_resident(
                    ds.bvh, (*ro, *rd), carry.t_min, tmax_eff,
                    (*ro, *pend.dir), pend.tmin, ntmax_eff, compact=compact)
            else:
                # flat cull, two-level and alpha-tested routes: the same
                # deferred structure in two dispatches
                hit = closest_hit_alpha(ds, cfg, ro, rd, carry.t_min, tmax_eff,
                                        compact=compact, presorted=presorted,
                                        count_evals=count_any)
        with span("rptr.nee"):
            if blocked is None:
                with span("rptr.shadow"):
                    if cfg.streamed and not alpha:
                        blocked = traverse_binned.occluded_binned(
                            ds.bvh, ro, pend.dir, pend.tmin, ntmax_eff,
                            rounds=1)
                    else:
                        blocked = occluded_alpha(
                            ds, cfg, ro, pend.dir, pend.tmin, ntmax_eff,
                            compact=compact, sort_shadow=compact,
                            count_evals=count_any)
                        if count_any:
                            (hit, ev_c), (blocked, ev_s) = hit, blocked
                            dbg = (dbg + ev_c + ev_s
                                   if cfg.debug_mode == _DBG_ANY_FULL
                                   else count(dbg, ev_c, carry.bounce_count))
            illum = v3.where(pend.traced & ~blocked, carry.illum + pend.contrib,
                             carry.illum)
        return hit, illum, dbg

    def visit_hit(carry: Carry, compact: bool = False,
                  presorted: bool = False):
        """Traverse, then the ``rptr.shade`` stage's first part
        (``shade.shade_hit``: hit attributes, textures, sky and emitter
        MIS), fused where ``shade.fused`` admits the configuration, counted
        by path (``profiling.count_shaded``). Returns (carry with the miss
        handled, hit shading context)."""
        hit, illum, dbg = traverse(carry, compact, presorted)
        with span("rptr.shade"):
            o = shade_hit(ds, cfg, fp, shade_mod.HitIn(
                ro=carry.ro, rd=carry.rd, illum=illum,
                throughput=carry.throughput, active=carry.active,
                prev_pdf=carry.prev_pdf, bounce_count=carry.bounce_count,
                total_t=carry.total_t, rays=carry.rays, hit=hit,
                foot=carry.foot))
            count_shaded(fused)
            carry = carry._replace(
                illum=o.illum, active=o.active, bounce_count=o.bounce_count,
                total_t=o.total_t, rays=o.rays, pend=o.pend, dbg=dbg,
            )
        return carry, (o.p, o.n_sh, o.gn, o.mat, o.w_o)

    def scatter_tail(carry: Carry, ctx, bounce: int, compact: bool = False,
                     sort_shadow: bool = False) -> Carry:
        """NEE + BSDF sample + RR of bounce ``bounce`` — skipped on the
        final bounce. ``sort_shadow``: the NEE occlusion queue (origins =
        fresh hit points) gets its own coherence sort. In the wavefront
        variant the shadow ray is queued for the next visit instead
        (integrator.py:1380-1400). Spans: the RNG draws, then the BSDF
        sample and roulette in ``rptr.shade``, NEE between them in
        ``rptr.nee``."""
        p, n_sh, gn, mat, w_o = ctx
        active, throughput = carry.active, carry.throughput
        total_t, dbg = carry.total_t, carry.dbg

        with span("rptr.shade"):
            # ---- RNG draws in reference order (shade_base_material.glsl:60-84)
            # at path-space dims (pathspace.h; integrator.py:1366-1376): the
            # bounce block starts at DIM_CAMERA_END + 8b, light dims first
            # {sel: +0, pos: +2}, then vertex dims {dir: +4, lobe: +6}, and
            # roulette reuses the free-path slot {+7}
            dim_base = DIM_CAMERA_END(cfg) + 8 * int(bounce)
            rv, bufs = cfg.rng_variant, ds.rng
            rng_state, pos_sample = pointsets.draw2t(rv, bufs, carry.rng_state,
                                                     dim_base + 2)
            rng_state, sel_sample = pointsets.draw2t(rv, bufs, rng_state, dim_base)
            rng_state, lobe_sample = pointsets.draw2t(rv, bufs, rng_state,
                                                      dim_base + 6)
            rng_state, dir_sample = pointsets.draw2t(rv, bufs, rng_state,
                                                     dim_base + 4)

        with span("rptr.nee"):
            # ---- NEE (one shadow ray per active lane)
            rays = carry.rays + active.to(carry.rays.dtype)
            pend = carry.pend
            if cfg.wavefront:
                # queue the candidate's shadow ray; a degenerate segment is
                # visible without tracing and applies here (per lane it is one
                # or the other, so the megakernel's accumulation order holds)
                cand = _nee_candidate(ds, cfg, p, n_sh, gn, mat, w_o, pos_sample,
                                      sel_sample, total_t)
                _count_nee_dropped(cand.dropped & active)
                scaled = throughput * cand.contrib
                illum = v3.where(cand.uncond & active, carry.illum + scaled,
                                 carry.illum)
                pend = PendingNEE(cand.dir, cand.eps, cand.shadow_tmax, scaled,
                                  cand.traced & active)
            else:
                # the NEE shadow ray's any-hit evaluations count in the
                # full-path mode (integrator.py:1400-1410)
                count_shadow = cfg.debug_mode == _DBG_ANY_FULL
                nee_contrib = _sample_direct_light(
                    ds, cfg, p, n_sh, gn, mat, w_o, pos_sample, sel_sample,
                    total_t, active, compact=compact, sort_shadow=sort_shadow,
                    count_evals=count_shadow,
                )
                if count_shadow:
                    nee_contrib, evals = nee_contrib
                    dbg = dbg + evals
                illum = v3.where(active, carry.illum + throughput * nee_contrib,
                                 carry.illum)

        with span("rptr.shade"):
            # the glossy-only mask, BSDF sample, footprint transport, next
            # ray and Russian roulette (shade.shade_scatter) on the
            # roulette's draw (pt_megakernel.glsl:713-730)
            rng_state, rr_sample = pointsets.draw1(rv, bufs, rng_state, dim_base + 7)
            o = shade_scatter(ds, cfg, fp, shade_mod.ScatterIn(
                ro=carry.ro, rd=carry.rd, throughput=throughput, active=active,
                prev_pdf=carry.prev_pdf, bounce_count=carry.bounce_count,
                total_t=total_t, foot=carry.foot, p=p, n_sh=n_sh, gn=gn,
                w_o=w_o, mat=mat, dir_sample=dir_sample,
                lobe_sample=lobe_sample, rr_sample=rr_sample))
            return carry._replace(
                ro=o.ro, rd=o.rd, t_min=o.t_min, illum=illum,
                throughput=o.throughput, active=o.active, prev_pdf=o.prev_pdf,
                rng_state=rng_state, rays=rays, pend=pend, foot=o.foot, dbg=dbg,
            )

    return visit_hit, scatter_tail


def initial_carry(ro: Vec3, rd: Vec3, rng_state, lane_mask=None,
                  foot: Optional[Footprint] = None,
                  wavefront: bool = False, debug: bool = False) -> Carry:
    """The path state before bounce 0; lanes outside ``lane_mask`` start
    dead. ``foot`` (textured scenes) is the camera footprint, broadcast to
    the lanes; ``wavefront`` adds the empty deferred shadow queue and
    ``debug`` the zero debug count."""
    n = ro.x.shape[0]
    dev = ro.x.device
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    one = torch.ones(n, dtype=torch.float32, device=dev)
    active0 = (
        torch.ones(n, dtype=torch.bool, device=dev)
        if lane_mask is None else lane_mask.to(torch.bool)
    )
    if foot is not None:
        foot = Footprint(*(f.expand(n) for f in foot))
    return Carry(
        ro=ro, rd=rd, t_min=zero, illum=Vec3(zero, zero, zero),
        throughput=Vec3(one, one, one), active=active0,
        prev_pdf=torch.full((n,), 2.0e16, device=dev),  # shading_interface:21
        bounce_count=torch.zeros(n, dtype=torch.int32, device=dev),
        total_t=zero, rng_state=rng_state,
        rays=torch.zeros(n, dtype=torch.int32, device=dev),
        pend=empty_pend(zero) if wavefront else None,
        foot=foot,
        dbg=torch.zeros(n, dtype=torch.int32, device=dev) if debug else None,
    )


def trace_paths(ds: DeviceScene, cfg: IntegratorConfig, fp: FrameParams,
                ro: Vec3, rd: Vec3, rng_state, lane_mask=None,
                footprint0=None, t_max0=None):
    """Trace a batch of paths; returns (rgb Vec3, alpha (N,), rays (N,)),
    and with ``cfg.debug_mode`` a 4th output, the DEBUG_MODE_* count (N,)
    int32 (hit.rchit:459-463): any-hit evaluations, or bounces in mode 3;
    the wavefront variant's last flush of its deferred queue is not
    counted, as in the reference (integrator.py:1722-1726).

    The bounce loop is unrolled in Python (the reference's
    ``cfg.unroll``). The last bounce only traverses and adds emitter/sky
    terms (shade_base_material.glsl:56-57). Once every lane is dead (and,
    in the wavefront variant, no shadow ray is queued) the remaining
    bounces are skipped: they could change nothing (the reference's
    whole-wave early out, pt_megakernel.glsl:445-449).
    ``cfg.compact`` coherence-sorts every traversal queue past bounce 0,
    and every NEE queue past bounce 0 sorts by its own origins
    (integrator.py:1536-1551). ``cfg.compact_lanes`` compacts the carry
    instead (``_compacted_bounces``). ``footprint0`` is the camera's texture
    footprint (``camera_footprint0``); textured scenes without one start
    from a zero footprint, as the reference does. ``t_max0`` (per lane, or
    None) bounds the primary segment, as a ray query's t_max does
    (integrator.py:1047-1052).

    Spans (``utils.profiling.span``): ``rptr.camera`` for the initial
    carry, ``rptr.bounce.<b>`` around each bounce, after its host read
    of whether any lane is live (``host_read("live")``), and ``rptr.blend``
    for the resolve to lane order.
    """
    check_supported(cfg)
    foot = None
    with span("rptr.camera"):
        if cfg.has_textures:
            foot = footprint0
            if foot is None:
                z = torch.zeros((), dtype=torch.float32, device=ro.x.device)
                foot = (z, z, z)
        carry = initial_carry(ro, rd, rng_state, lane_mask, foot=foot,
                              wavefront=cfg.wavefront,
                              debug=bool(cfg.debug_mode))
    visit_hit, scatter_tail = _make_bounce_fns(ds, cfg, fp, t_max0)
    n = ro.x.shape[0]
    # carry compaction (integrator.py:1606-1610): not for a bounded primary
    # segment, debug counters or depth 1, and only with more than one
    # prefix size
    sizes = [n >> j for j in range(_COMPACT_MAX_HALVINGS + 1)
             if (n >> j) >= _COMPACT_LANE_QUANTUM
             and (n >> j) % _COMPACT_LANE_QUANTUM == 0]
    use_lane_compact = (cfg.compact_lanes and t_max0 is None
                        and not cfg.debug_mode and cfg.max_path_depth > 1
                        and len(sizes) > 1)
    lane_id = None
    for i in range(1 if use_lane_compact else cfg.max_path_depth):
        live = carry.active.any()
        if cfg.wavefront:
            live = live | carry.pend.traced.any()
        if not host_read("live", live):
            break
        with span("rptr.bounce", i):
            compact = cfg.compact and i > 0
            carry, ctx = visit_hit(carry, compact=compact)
            if i < cfg.max_path_depth - 1:
                carry = scatter_tail(carry, ctx, i, compact=compact,
                                     sort_shadow=i > 0)
    if use_lane_compact:
        carry, lane_id = _compacted_bounces(ds, cfg, carry, sizes, visit_hit,
                                            scatter_tail)
    illum = carry.illum
    if cfg.wavefront and host_read("wavefront_flush",
                                   carry.pend.traced.any()):
        # a shadow queue that no later visit resolved (integrator.py:
        # 1695-1713): never with the standard depth schedule, whose last
        # bounce queues nothing
        pend = carry.pend
        with span("rptr.nee"):
            with span("rptr.shadow"):
                blocked = occluded_alpha(
                    ds, cfg, carry.ro, pend.dir, pend.tmin,
                    torch.where(pend.traced, pend.tmax, 0.0))
            illum = v3.where(pend.traced & ~blocked, illum + pend.contrib,
                             illum)
    bounce_count, rays, dbg = carry.bounce_count, carry.rays, carry.dbg
    with span("rptr.blend"):
        if lane_id is not None:
            # the carry is in its cumulative sorted order; lane_id maps a
            # sorted slot to its lane, so its inverse gathers lane order
            # back (integrator.py:1715-1717)
            inv = inverse_permutation(lane_id)
            illum = _permute_lanes(illum, inv)
            bounce_count, rays = bounce_count[inv], rays[inv]
        alpha = torch.where(bounce_count == 0, 0.0, 1.0)
    if cfg.debug_mode:
        return illum, alpha, rays, (bounce_count if cfg.debug_mode == _DBG_BOUNCE
                                    else dbg)
    return illum, alpha, rays


def _compacted_bounces(ds: DeviceScene, cfg: IntegratorConfig, carry: Carry,
                       sizes, visit_hit, scatter_tail):
    """Bounces 1.. of carry compaction (integrator.py:1606-1690): before
    each, a stable argsort of the carry by its coherence key (live lanes,
    those with a queued shadow ray included, first), then the bounce on the
    smallest prefix in ``sizes`` that holds every live lane, presorted, its
    NEE queue sorted by its own origins; the dead tail rides along. One
    host read per bounce, the live count (``host_read("compaction_live")``),
    picks the prefix (and ends the loop when no lane is live). Every kernel
    is a per-lane function, so no lane's result depends on the order.
    Returns (carry in sorted order, lane_id: the lane of each sorted
    slot)."""
    n = carry.active.shape[0]
    lo, hi = _scene_bounds_of(ds)
    lane_id = torch.arange(n, device=carry.active.device)
    for b in range(1, cfg.max_path_depth):
        live = carry.active
        if cfg.wavefront:
            live = live | carry.pend.traced
        live_cnt = host_read("compaction_live", live.sum())
        if live_cnt == 0:
            break
        with span("rptr.bounce", b):
            with span("rptr.sort"):
                perm = torch.argsort(_carry_coherence_key(
                    carry.ro, carry.rd, live, lo, hi), stable=True)
                carry = _permute_lanes(carry, perm)
                lane_id = lane_id[perm]
            m = min(w for w in sizes if live_cnt <= w)
            head = _map_lanes(lambda a: a[:m], carry)
            head, ctx = visit_hit(head, compact=False, presorted=True)
            if b < cfg.max_path_depth - 1:
                head = scatter_tail(head, ctx, b, compact=False,
                                    sort_shadow=True)
            with span("rptr.sort"):
                carry = head if m == n else _map_lanes(
                    lambda h, a: torch.cat([h, a[m:]]), head, carry)
    return carry, lane_id


def camera_rays_v(view: ViewBuffers, px, py, dims, j0, j1):
    """Primary rays (pt_megakernel.glsl:315-323): px/py int tensors,
    (j0, j1) jitter in [0,1), ``dims`` = (width, height). Returns (ro, rd)."""
    point_x = (px.to(torch.float32) + 0.5 + (j0 - 0.5)) / dims[0]
    point_y = (py.to(torch.float32) + 0.5 + (j1 - 0.5)) / dims[1]
    du, dv, tl = view.cam_du, view.cam_dv, view.cam_dir_top_left
    rd = v3.normalize(
        Vec3(
            point_x * du[0] + point_y * dv[0] + tl[0],
            point_x * du[1] + point_y * dv[1] + tl[1],
            point_x * du[2] + point_y * dv[2] + tl[2],
        )
    )
    shape = px.shape
    ro = Vec3(
        view.cam_pos[0].expand(shape),
        view.cam_pos[1].expand(shape),
        view.cam_pos[2].expand(shape),
    )
    return ro, rd


# ---------------------------------------------------------------------------
# Ray-differential texture footprint (rt/footprint.glsl; integrator.py:
# 1752-1830)
# ---------------------------------------------------------------------------


def camera_footprint0(cfg: IntegratorConfig, fp: FrameParams,
                      view: ViewBuffers, dims, rd: Vec3):
    """Initial texture footprint from the pixel differentials
    (pt_megakernel.glsl:340-351): dpdx = cam_du/W * pixel_radius etc.
    None unless the config traces textures."""
    if not cfg.has_textures:
        return None
    # f32 scales, as the reference divides f32 scalars on the device
    sx = float(np.float32(fp.pixel_radius) / np.float32(dims[0]))
    sy = float(np.float32(fp.pixel_radius) / np.float32(dims[1]))
    dpdx = Vec3(view.cam_du[0] * sx, view.cam_du[1] * sx, view.cam_du[2] * sx)
    dpdy = Vec3(view.cam_dv[0] * sy, view.cam_dv[1] * sy, view.cam_dv[2] * sy)
    return _dpdxy_to_footprint_v(rd, dpdx, dpdy)


def DIM_CAMERA_END(cfg: IntegratorConfig) -> int:
    """Path-space camera dimension count (pathspace.h; integrator.py:1833):
    the simplified camera uses dims 0-1; thin-lens DoF the full camera with
    its aperture at dims 4-5 (``camera_setup``), so its bounces start at dim
    6."""
    return 6 if cfg.enable_dof else 2


def camera_setup(cfg: IntegratorConfig, view: ViewBuffers, px, py, dims,
                 state, bufs: Optional[pointsets.RngBuffers] = None,
                 fp: Optional[FrameParams] = None):
    """Pixel jitter draw at dims 0-1 + primary ray (perspective.rgen:
    95-109; integrator.py:1840-1867). ``bufs`` are the RNG variant's tables
    (``DeviceScene.rng``). With ``cfg.enable_dof`` the thin lens: an
    aperture draw at dims 4-5, the origin moved by a disk sample of radius
    ``fp.aperture_radius`` in the normalised (du, dv) screen basis, and the
    ray re-aimed at its point at ``fp.focus_distance``. Returns (state, ro,
    rd)."""
    state, (j0, j1) = pointsets.draw2t(cfg.rng_variant, bufs, state, 0)
    ro, rd = camera_rays_v(view, px, py, dims, j0, j1)
    if not cfg.enable_dof:
        return state, ro, rd
    fp = fp if fp is not None else FrameParams()
    state, (r0, r1) = pointsets.draw2t(cfg.rng_variant, bufs, state, 4)
    focus = ro + rd * fp.focus_distance
    phi = (2.0 * math.pi) * r0
    r = torch.sqrt(r1) * fp.aperture_radius
    lx, ly = torch.cos(phi) * r, torch.sin(phi) * r

    def unit(a):
        return a / torch.clamp(torch.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]),
                               min=1e-20)

    du, dv = unit(view.cam_du), unit(view.cam_dv)
    ro = Vec3(ro.x + lx * du[0] + ly * dv[0],
              ro.y + lx * du[1] + ly * dv[1],
              ro.z + lx * du[2] + ly * dv[2])
    return state, ro, v3.normalize(focus - ro)


# ---------------------------------------------------------------------------
# 16x16 packet swizzle and planar framebuffer (integrator.py:1969-2065)
# ---------------------------------------------------------------------------


def swizzle_host(tile_w: int, tile_h: int, rays_per_pass: int = RAYS_PER_PASS):
    """The 16x16 pixel-tile order of a (tile_w, tile_h) frame, padded to
    ``nc * chunk`` slots with at most ``rays_per_pass`` rays per pass.

    Returns ``(px, py, valid, lin, inv, nc, chunk)``: ``lin[slot]`` is the
    slot's linear pixel (``tile_h * tile_w`` for padding), ``inv[pixel]``
    the pixel's slot."""
    ts = 16
    bw = -(-tile_w // ts)
    bh = -(-tile_h // ts)
    n_rays = bw * bh * ts * ts
    idx = np.arange(n_rays)
    block = idx // (ts * ts)
    within = idx % (ts * ts)
    px = (block % bw) * ts + within % ts
    py = (block // bw) * ts + within // ts
    valid = (px < tile_w) & (py < tile_h)
    px = np.minimum(px, tile_w - 1).astype(np.int32)
    py = np.minimum(py, tile_h - 1).astype(np.int32)
    lin = np.where(valid, py * tile_w + px, tile_h * tile_w).astype(np.int32)
    chunk = min(n_rays, rays_per_pass)
    n_pad = n_rays + ((-n_rays) % chunk)

    def pad(a, fill):
        if n_pad == n_rays:
            return a
        return np.concatenate([a, np.full(n_pad - n_rays, fill, a.dtype)])

    px, py = pad(px, 0), pad(py, 0)
    valid = pad(valid, False)
    lin = pad(lin, tile_h * tile_w)
    inv = np.zeros(tile_h * tile_w, np.int32)
    inv[lin[valid]] = np.nonzero(valid)[0].astype(np.int32)
    return px, py, valid, lin, inv, n_pad // chunk, chunk


def planes_to_image(planes_np: np.ndarray, width: int, tile_h: int,
                    rays_per_pass: int = RAYS_PER_PASS) -> np.ndarray:
    """Host blit: planar-swizzled (4, n_pad) -> (tile_h, width, 4)."""
    inv_np = swizzle_host(width, tile_h, rays_per_pass)[4]
    return np.ascontiguousarray(planes_np[:, inv_np].T).reshape(tile_h, width, 4)


def image_to_planes(img: np.ndarray, width: int, tile_h: int,
                    rays_per_pass: int = RAYS_PER_PASS) -> np.ndarray:
    """Host re-swizzle, the inverse of ``planes_to_image``: (tile_h, width,
    4) -> planar-swizzled (4, n_pad), padding slots 0 (integrator.py:
    2036-2042)."""
    lin_np = swizzle_host(width, tile_h, rays_per_pass)[3]
    flat = np.concatenate(
        [img.reshape(-1, 4), np.zeros((1, 4), img.dtype)], axis=0)
    return np.ascontiguousarray(flat[lin_np].T)


def render_tile_host(pass_fn, fp: FrameParams, view: ViewBuffers, width: int,
                     height: int, spp: int, tables, on_pass=None):
    """One frame of ``spp`` samples on fresh zero chunks, blended from base
    0, assembled to an (H, W, 4) image of the samples' mean
    (integrator.py:2259-2305): one ``pass_fn`` (``make_pass_fn``) call per
    (sample, chunk), as the planar path runs them. ``tables`` is the
    frame's (px, py, valid) chunk lists and its (H * W,) pixel -> slot
    index on the device. ``on_pass(acc, s, c)`` runs after each pass.
    Returns (image, the per-pass ray counts as device scalars)."""
    px_c, py_c, valid_c, inv = tables
    accs = [tuple(torch.zeros_like(p, dtype=torch.float32) for _ in range(4))
            for p in px_c]
    rays = []
    for s in range(spp):
        for c, acc in enumerate(accs):
            rays.append(pass_fn(fp, view, acc, px_c[c], py_c[c], valid_c[c],
                                s, 0))
            if on_pass is not None:
                on_pass(acc, s, c)
    planes = torch.stack([torch.cat([a[k] for a in accs]) for k in range(4)])
    return planes[:, inv].T.reshape(height, width, 4), rays


def tile_tables(tile_w: int, tile_h: int, device, x0: int = 0, y0: int = 0,
                rays_per_pass: int = RAYS_PER_PASS):
    """``render_tile_host``'s ``tables`` for a ``tile_w`` x ``tile_h`` pixel
    tile whose corner is frame pixel (x0, y0), on ``device``: the tile's
    swizzle chunks with frame pixel coordinates, and its (tile_h * tile_w,)
    pixel -> slot index."""
    px, py, valid, _lin, inv, nc, chunk = swizzle_host(tile_w, tile_h,
                                                       rays_per_pass)

    def split(a):
        t = torch.from_numpy(np.ascontiguousarray(a.reshape(nc, chunk)))
        t = t.to(device)
        return [t[c] for c in range(nc)]

    return (split(px + np.int32(x0)), split(py + np.int32(y0)), split(valid),
            torch.from_numpy(inv.astype(np.int64)).to(device))


def render_tile(ds: DeviceScene, cfg: IntegratorConfig, fp: FrameParams,
                view: ViewBuffers, width: int, height: int, spp: int,
                y0: int = 0, tile_h: Optional[int] = None, x0: int = 0,
                tile_w: Optional[int] = None, tables=None):
    """``spp`` samples of a pixel tile (integrator.py:1876-1916): the
    (tile_h, tile_w, 4) mean of the samples (radiance, alpha) and the
    tile's traced rays (a device scalar). The tile is ``tile_w`` x
    ``tile_h`` pixels from frame pixel (x0, y0), the whole frame by
    default; ``width`` and ``height`` stay the frame's, so the camera
    mapping and the RNG's pixel keying are those of the whole frame and a
    tile's pixels equal the whole frame's. Runs on the device of ``ds``
    and ``view``; ``tables`` (``tile_tables``) may be passed to reuse
    them."""
    tile_h = height if tile_h is None else int(tile_h)
    tile_w = width if tile_w is None else int(tile_w)
    if tables is None:
        tables = tile_tables(tile_w, tile_h, view.cam_pos.device, x0, y0)
    img, rays = render_tile_host(make_pass_fn(ds, cfg, width, height), fp,
                                 view, tile_w, tile_h, spp, tables)
    return img, torch.stack(rays).sum()


def make_pass_fn(ds: DeviceScene, cfg: IntegratorConfig, width: int,
                 height: int):
    """The single-pass program for a scene: one sample over one chunk,
    accumulated into ``acc`` IN PLACE (torch updates the channel buffers
    where they lie instead of the reference's donated functional update).
    Returns ``pass_fn(fp, view, acc, px, py, valid, s, blend_base)`` ->
    the chunk's summed ray count (a device scalar)."""
    check_supported(cfg)
    dims = (float(width), float(height))

    def pass_fn(fp: FrameParams, view: ViewBuffers, acc, px, py, valid,
                s: int, blend_base: int):
        """``s`` is the in-batch sample index and ``blend_base`` the
        number of samples already in ``acc`` (process_samples.comp:
        116-131: ``acc += (x - acc) / (k + 1)``, applied per sample).
        Span ``rptr.pass``."""
        with span("rptr.pass"):
            sample_index = (fp.sample_offset + s) & M32
            blend_k = blend_base + s
            with span("rptr.camera"):
                state = pointsets.make_state(
                    cfg.rng_variant, sample_index, fp.shot_offset, px, py,
                    width, bufs=ds.rng)
                state, ro, rd = camera_setup(cfg, view, px, py, dims, state,
                                             bufs=ds.rng, fp=fp)
                foot = camera_footprint0(cfg, fp, view, dims, rd)
            rgb, alpha, nrays = trace_paths(
                ds, cfg, fp, ro, rd, state, lane_mask=valid, footprint0=foot)
            with span("rptr.blend"):
                blend_sample(acc, (rgb.x, rgb.y, rgb.z, alpha), valid,
                             blend_k)
                return nrays.sum()

    return pass_fn


def blend_sample(acc, samples, valid, blend_k: int) -> None:
    """The progressive average ``acc += (x - acc) / (k + 1)`` of one sample
    into the four planar channels ``acc``, in place; invalid lanes keep
    ``acc`` (process_samples.comp:116-131)."""
    # f32 weight, as the reference computes it on the device
    w = float(np.float32(1.0) / (np.float32(blend_k) + np.float32(1.0)))
    for a, smp in zip(acc, samples):
        if blend_k == 0:
            # exact overwrite: a + (x - a) / 1 would round
            a.copy_(torch.where(valid, smp, 0.0))
        else:
            a.add_((torch.where(valid, smp, a) - a).mul_(w))


def _count_image(ds: DeviceScene, cfg: IntegratorConfig, fp: FrameParams,
                 view: ViewBuffers, width: int, height: int, which: int,
                 rays_per_pass: int):
    """One sample of every pixel through the monolithic ``trace_paths``,
    chunk by chunk in the swizzle order; output ``which`` of each lane
    (dead lanes 0) as an (H, W) int32 image."""
    check_supported(cfg)
    dims = (float(width), float(height))
    px, py, valid, _lin, inv, nc, chunk = swizzle_host(width, height,
                                                       rays_per_pass)
    dev = view.cam_pos.device

    def cut(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).view(nc, chunk)

    px, py, valid = cut(px), cut(py), cut(valid)
    counts = []
    for c in range(nc):
        state = pointsets.make_state(cfg.rng_variant, fp.sample_offset,
                                     fp.shot_offset, px[c], py[c], width,
                                     bufs=ds.rng)
        state, ro, rd = camera_setup(cfg, view, px[c], py[c], dims, state,
                                     bufs=ds.rng, fp=fp)
        out = trace_paths(ds, cfg, fp, ro, rd, state, lane_mask=valid[c],
                          footprint0=camera_footprint0(cfg, fp, view, dims, rd))
        counts.append(torch.where(valid[c], out[which], 0).to(torch.int32))
    inv = torch.from_numpy(inv.astype(np.int64)).to(dev)
    return torch.cat(counts)[inv].reshape(height, width)


def render_ray_stats_host(ds: DeviceScene, cfg: IntegratorConfig,
                          fp: FrameParams, view: ViewBuffers, width: int,
                          height: int, rays_per_pass: int = RAYS_PER_PASS):
    """One-sample traced-ray-count image (H, W) int32, closest and shadow
    rays per pixel: the REPORT_RAY_STATS image (integrator.py:2154-2193,
    ``make_ray_stats_fn`` and ``render_ray_stats_host`` there)."""
    return _count_image(ds, cfg, fp, view, width, height, 2, rays_per_pass)


def render_debug_host(ds: DeviceScene, cfg: IntegratorConfig, fp: FrameParams,
                      view: ViewBuffers, width: int, height: int,
                      rays_per_pass: int = RAYS_PER_PASS):
    """One-sample DEBUG_MODE_* count image (H, W) int32 of
    ``cfg.debug_mode`` (integrator.py:2196-2238, ``make_debug_fn`` and
    ``render_debug_host`` there)."""
    if not cfg.debug_mode:
        raise ValueError("render_debug_host needs a cfg.debug_mode")
    return _count_image(ds, cfg, fp, view, width, height, 3, rays_per_pass)
