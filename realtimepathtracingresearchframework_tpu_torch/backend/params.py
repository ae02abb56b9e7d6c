"""Options and parameter system.

TPU-native equivalent of the reference's X-macro options lattice
(``librender/render_params.glsl.h:56-174``):

- :class:`RenderBackendOptions` — compile-time-ish options. Each option is
  tagged with *stage flags* describing which pipeline stages it affects
  (``render_params.glsl.h:107-114``). Options that affect device code become
  part of the jit cache key (they are static arguments / Python-level
  constants folded into the traced program); CPU-only options never trigger
  a re-trace. This mirrors how the reference sorts shader-affecting options
  into ``-DRBO_*`` defines hashed into its SPIR-V cache key
  (``librender/gpu_programs.cpp:57-95``).

- :class:`RenderParams` — per-frame runtime parameters
  (``render_params.glsl.h:129-152``). These are traced values: changing them
  does NOT recompile.

- :class:`SceneConfig` — sun/sky/bump configuration
  (``render_params.glsl.h:154-159``).

- :class:`LightSamplingConfig` — RIS binning configuration
  (``render_params.glsl.h:122-127``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# ---------------------------------------------------------------------------
# Enums and stage flags (reference: render_params.glsl.h:34-70,107-114)
# ---------------------------------------------------------------------------

RNG_VARIANT_UNIFORM = 0
RNG_VARIANT_BN = 1
RNG_VARIANT_SOBOL = 2
RNG_VARIANT_Z_SBL = 3
RNG_VARIANT_NAMES = ("UNIFORM", "BN", "SOBOL", "Z_SBL")

LIGHT_SAMPLING_VARIANT_NONE = 0
LIGHT_SAMPLING_VARIANT_RIS = 1
LIGHT_SAMPLING_VARIANT_NAMES = ("NONE", "RIS")

OUTPUT_CHANNEL_COLOR = 0
OUTPUT_CHANNEL_ALBEDO_ROUGHNESS = 1
OUTPUT_CHANNEL_NORMAL_DEPTH = 2
OUTPUT_CHANNEL_MOTION_JITTER = 3
OUTPUT_CHANNEL_NAMES = ("COLOR", "ALBEDO_ROUGHNESS", "NORMAL_DEPTH", "MOTION_JITTER")

DEBUG_MODE_OFF = 0
DEBUG_MODE_ANY_HIT_COUNT_FULL_PATH = 1
DEBUG_MODE_ANY_HIT_COUNT_PRIMARY_VISIBILITY = 2
DEBUG_MODE_BOUNCE_COUNT = 3

REPROJECTION_MODE_NONE = 0
REPROJECTION_MODE_DISCARD_HISTORY = 1
REPROJECTION_MODE_ACCUMULATE = 2

TONEMAP_MODE_OFF = -1
TONEMAP_MODE_NO = 0
TONEMAP_MODE_NEUTRAL = 1
TONEMAP_MODE_FAST = 2

# compile-time config (reference: render_params.glsl.h:15-19)
MAX_PATH_DEPTH = 9
DEFAULT_RR_PATH_DEPTH = 2
BINNED_LIGHTS_BIN_MAX_SIZE = 16
GLOSSY_MODE_ROUGHNESS_THRESHOLD = 0.1

# Stage flags controlling which jitted pipelines must be rebuilt when an
# option changes (reference: render_params.glsl.h:107-114).
RBO_STAGES_HOST_PIPELINE = 0x0
RBO_STAGES_CPU_ONLY = 0x80000000
RBO_STAGES_ALL = 0x7FFF0000
RBO_STAGES_INTEGRATOR = 0x010000
RBO_STAGES_RASTERIZED = 0x020000
RBO_STAGES_RAYTRACED = 0x040000
RBO_STAGES_PROCESSING = 0x1000000
GPU_PROGRAM_FEATURE_MEGAKERNEL = 0x010000  # megakernel-only integrator option


# Option registry: name -> (default, stage_flags). The single source of truth
# for which options exist and what they invalidate, mirroring the
# RENDER_BACKEND_OPTIONS X-macro (render_params.glsl.h:75-105).
RENDER_BACKEND_OPTION_STAGES = {
    "rng_variant": RBO_STAGES_INTEGRATOR,
    "light_sampling_variant": RBO_STAGES_INTEGRATOR,
    "light_sampling_bucket_count": RBO_STAGES_INTEGRATOR,
    "unroll_bounces": GPU_PROGRAM_FEATURE_MEGAKERNEL,
    "render_upscale_factor": RBO_STAGES_CPU_ONLY,
    "enable_rayqueries": RBO_STAGES_INTEGRATOR,
    "force_bvh_rebuild": RBO_STAGES_CPU_ONLY,
    "rebuild_triangle_budget": RBO_STAGES_CPU_ONLY,
    "enable_taa": RBO_STAGES_CPU_ONLY,
    "enable_raytraced_dof": RBO_STAGES_CPU_ONLY,
    "debug_mode": RBO_STAGES_INTEGRATOR,
    "aniso_taps": RBO_STAGES_INTEGRATOR,
    "quantized_geometry": RBO_STAGES_CPU_ONLY,
}


@dataclass(frozen=True)
class RenderBackendOptions:
    """Hashable options object; used as a jit static argument.

    Reference: ``RenderBackendOptions`` (render_params.glsl.h:75-119).
    """

    rng_variant: int = RNG_VARIANT_UNIFORM
    light_sampling_variant: int = LIGHT_SAMPLING_VARIANT_NONE
    light_sampling_bucket_count: int = 16
    # default ON: measured on v5e the statically unrolled bounce loop is
    # ~2% faster AND compiles 5x quicker than the fori_loop form
    # (DYNAMIC_LOOP_BOUNCES), 30s vs 157s cold at 1080p depth 9
    unroll_bounces: bool = True
    render_upscale_factor: int = 1
    enable_rayqueries: bool = False
    force_bvh_rebuild: bool = False
    rebuild_triangle_budget: int = 500000
    enable_taa: bool = False
    enable_raytraced_dof: bool = True
    debug_mode: int = DEBUG_MODE_OFF
    # two-level BLAS/TLAS instanced traversal (ops/tlas.py): per-mesh object
    # BVHs + instance TLAS; animation rebuilds only the instance-count TLAS
    use_tlas: bool = False
    # anisotropic texture filtering taps (0 = isotropic mip): the
    # textureGrad filtering the reference's sampler hardware provides;
    # on TPU each tap is a full gather set, so it is opt-in
    aniso_taps: int = 0
    # device-side quantized geometry for the streamed path: leaf tiles
    # store per-subtree 16-bit vertex codes decoded in-kernel (the
    # scene.cpp:622-644 quantized upload + dequantize.glsl analogue) —
    # half the HBM footprint / per-visit DMA bytes on large scenes
    quantized_geometry: bool = False

    def replace(self, **kw) -> "RenderBackendOptions":
        return dataclasses.replace(self, **kw)

    def device_key(self, relevant_stages: int = RBO_STAGES_ALL) -> Tuple:
        """The subset of options that affect traced device code for the given
        stages — the jit-cache key component. CPU-only options are excluded,
        mirroring ``options_changed`` stage filtering
        (librender/render_backend.cpp:59-96)."""
        key = []
        for f in dataclasses.fields(self):
            stages = RENDER_BACKEND_OPTION_STAGES.get(f.name, RBO_STAGES_ALL)
            if stages == RBO_STAGES_CPU_ONLY:
                continue
            if stages & (relevant_stages | 0x0000FFFF) or stages == 0:
                key.append((f.name, getattr(self, f.name)))
        return tuple(key)


def options_changed(
    a: RenderBackendOptions, b: RenderBackendOptions, stages: int
) -> bool:
    """True if any option relevant to ``stages`` differs between a and b."""
    for f in dataclasses.fields(RenderBackendOptions):
        flags = RENDER_BACKEND_OPTION_STAGES.get(f.name, RBO_STAGES_ALL)
        if flags == RBO_STAGES_CPU_ONLY:
            relevant = stages & RBO_STAGES_CPU_ONLY
        else:
            relevant = flags & stages
        if relevant and getattr(a, f.name) != getattr(b, f.name):
            return True
    return False


def normalized_options(
    opts: RenderBackendOptions, available: RenderBackendOptions, mask: RenderBackendOptions
) -> RenderBackendOptions:
    """Clamp ``opts`` to the available option set where ``mask`` marks options
    the target variant supports; unsupported options revert to ``available``.

    Reference: ``normalized_options`` (librender/render_backend.cpp:59-96) —
    used by the invalid-configuration recovery loop (app.cpp:397-432).
    """
    out = {}
    for f in dataclasses.fields(RenderBackendOptions):
        if getattr(mask, f.name):
            out[f.name] = getattr(opts, f.name)
        else:
            out[f.name] = getattr(available, f.name)
    return RenderBackendOptions(**out)


@dataclass(frozen=True)
class RenderParams:
    """Per-frame runtime render parameters (traced, not static).

    Reference: ``RenderParams`` (render_params.glsl.h:129-152). Fields that
    select code paths at trace time in our build (max_path_depth,
    output_channel, ...) are still kept here for API parity; the renderer
    hoists them into static jit arguments where needed.
    """

    batch_spp: int = 1
    max_path_depth: int = MAX_PATH_DEPTH
    rr_path_depth: int = DEFAULT_RR_PATH_DEPTH
    glossy_only_mode: int = 0

    aperture_radius: float = 0.0
    focus_distance: float = 2.5
    pixel_radius: float = 1.0
    variance_radius: float = 4.0

    output_channel: int = OUTPUT_CHANNEL_COLOR
    output_moment: int = 0
    exposure: float = 0.0
    early_tone_mapping_mode: int = TONEMAP_MODE_OFF

    reprojection_mode: int = REPROJECTION_MODE_NONE
    spp_accumulation_window: int = 8
    enable_raster_taa: int = 0
    render_upscale_factor: int = 1

    focal_length: float = 35.0

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SceneConfig:
    """Sun/sky and scene-wide shading configuration.

    Reference: ``SceneConfig`` (render_params.glsl.h:154-159).
    """

    bump_scale: float = 1.0
    sun_dir: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    turbidity: float = 3.0
    albedo: Tuple[float, float, float] = (0.2, 0.2, 0.2)
    # distance-based LoD screen-space error threshold (util/lod.cpp);
    # honored by the renderer when the scene has LoD groups
    lod_threshold: float = 0.02

    def replace(self, **kw) -> "SceneConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LightSamplingConfig:
    """Binned-RIS light sampling configuration.

    Reference: ``LightSamplingConfig`` (render_params.glsl.h:122-127).
    """

    light_mis_angle: float = 0.0
    bin_size: int = 16
    min_perceived_receiver_dist: float = 15.0
    min_radiance: float = 0.0


@dataclass(frozen=True)
class RenderRayQuery:
    """Cross-backend ray query record (render_params.glsl.h:162-168)."""

    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    mode_or_data: int = 0
    dir: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    t_max: float = 1.0e30


DEFAULT_RAY_QUERY_BUDGET = 512 * 512
