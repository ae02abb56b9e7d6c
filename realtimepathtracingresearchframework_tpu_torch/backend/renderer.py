"""Renderer — the PyTorch counterpart of the reference's
``backend/renderer.py`` (the fast, planar path only).

``Renderer(device=...)`` owns the device scene and the per-chunk
accumulation buffers: ``set_scene`` flattens the scene, picks the traversal
route by triangle count as the reference does on a chip (``route_for``;
renderer.py:588-608, 815-847), builds the SAH BVH on the host with that
route's leaf size and packs it for the resident kernels, or packs the
streamed two-level layout (renderer.py:782-797), and uploads the attribute
tables (in BVH-row order on the resident routes, in source-triangle order
on the streamed route; renderer.py:894-917) plus the lights and sky
(renderer.py:961-1058). ``render`` runs the frame: the host chunk loop of
the monolithic pass (renderer.py:1244-1440), or on large resident scenes
the bounce-major wavefront executor (renderer.py:1340-1370;
``ops/wavefront_host.py``), accumulating in place, and returns the
``RenderStats``. ``readback_accumulation`` un-swizzles the planar buffers
into an (H, W, 4) image; ``readback_framebuffer`` resolves them first to
the sRGB display image (``ops/resolve.py``; renderer.py:1525-1552).
``configure_for`` applies new options, rebuilding the scene where they
change what ``set_scene`` builds (renderer.py:425-470).
``render_ray_queries`` answers closest-hit ray queries through the route's
kernel, or traces the full integrator over them (renderer.py:1734-1871);
``render_aovs`` / ``readback_aov`` render the first-hit AOVs
(``ops/aov.py``; renderer.py:2085-2126).

Routes: up to 16,383 triangles the resident walk K1; from 16,384 to
90,000 the flat-cull kernels K2 and K3 with coherence-sorted queues and the
wavefront executor; above 90,000 (or with
``RPTR_FORCE_STREAMED_TRAVERSAL``) the streamed route: the monolithic pass
with the sorted streamed walk K4 for closest hits and one binned round of
K5 for shadow rays (``RPTR_STREAM_CLOSEST`` picks the closest-hit
strategy: sorted, ordered, binned or multislot), on f32 tiles or, with
``options.quantized_geometry``, 16-bit quantized ones. Up to 90,000
triangles ``RPTR_TRAVERSAL_V1`` selects the v1 walk K8a/K8b
(``ops/traverse_v1.py``) at leaf 128: the monolithic pass, unsorted, one
merged K8 launch per bounce in ``PT_WAVEFRONT`` (renderer.py:815-847,
1011-1012). With
``options.use_tlas`` the scene is instanced two-level (renderer.py:
692-769): a BLAS per unique mesh in object space and a TLAS over the
instances, through K6 within its caps (``MAX_INSTANCES`` instances,
``MAX_TOTAL_NODES`` BLAS + TLAS nodes) and K7 past them at any number of
(instance, chunk) entries (the reference's cap of 2,048 is its SMEM entry
table, and its XLA walk past it is the port's CPU oracle only).
``set_animation_frame`` rebuilds only the TLAS side of a two-level scene
(renderer.py:1888-1962), and refits or rebuilds a flattened scene's BVH
(renderer.py:1963-2060). ``options.rng_variant`` picks the RNG variant
(LCG, Sobol, Z-Sobol or blue noise); ``set_scene`` and ``configure_for``
build its tables (``pointsets.build_rng_buffers``). Textured scenes upload a texture atlas and, where a textured
material can cut, run the alpha test on every route (renderer.py:918-938).
``options.light_sampling_variant`` RIS re-lays the emitters in bins of equal
power for binned RIS light selection, as the reference's binned-lights
extension does (extensions.py:158-200). ``set_variant`` selects any
registered variant but ``RQ_CLOSEST`` (renderer.py:290-321):
``PT_WAVEFRONT`` defers each bounce's NEE shadow ray to the next bounce's
merged dispatch, ``RT_DEBUG`` and ``GBUFFER`` show the first-hit AOVs
(``_render_debug_variant``), and every other one renders through the
megakernel, as there. ``render_ray_stats`` and ``render_debug_image``
render one sample's ray-count and DEBUG_MODE_* images (renderer.py:
1589-1650).

The image-domain frame path (renderer.py:1245-1520): under
``REPROJECTION_MODE_ACCUMULATE``, ``options.enable_taa`` or a
``render_upscale_factor`` above 1, ``render`` renders the frame on fresh
chunks through the monolithic pass (``integrator.render_tile_host``),
reprojects the history by the motion AOV (``ops/taa.py``), starts it anew
(DISCARD_HISTORY) or averages it in (``resolve.accumulate_history``),
resolves the display image at the upscale (``resolve.resolve_framebuffer``)
and runs the TAA processing step (``backend/extensions.py``). The
accumulation then lives as (H, W, 4) images (``accum``, ``framebuffer``)
instead of the planar chunks; switching back re-swizzles it. The
extensions (pointsets, binned lights, and the TAA, example and
profiling-tools processing steps) contribute the scene's RNG tables and
light bins and hook the frame; ``timers`` holds the reference's profiling
markers; ``save_state`` / ``load_state`` checkpoint the accumulation in the
reference's ``.npz`` keys; ``render_raster_gbuffer`` rasterises the
flattened scene (``ops/raster.py``); ``hot_reload`` reloads edited
rendering modules; scenes with LoD groups are re-flattened when the
camera's LoD selection changes (renderer.py:669-690, 1166-1190,
1963-1981). ``warmup_async`` builds and loads the route's kernels and runs
a first pass on a thread ahead of the first frame (renderer.py:532-590);
``sync_interval`` sets how often ``render`` waits for a frame's end
(renderer.py:141-144). Each kernel runs on ``device="cuda"``, its plain
version on ``device="cpu"`` (the tests' device). There is no CPU fallback
for a CUDA renderer.

``Renderer(devices=[...])`` renders across several devices (renderer.py:
154-168): one replica of the device scene per device
(``parallel.mesh.replicate``, tensors only), the planar frame's swizzle
chunks round-robin over them, gathered on the first device at the readback;
everything else runs on the first device, and the wavefront executor is
off. Each kernel's wrapper launches on its operands' device.
"""

from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.backend import (
    extensions as ext_mod,
)
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    REPROJECTION_MODE_ACCUMULATE,
    REPROJECTION_MODE_DISCARD_HISTORY,
    RNG_VARIANT_UNIFORM,
    RenderBackendOptions,
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.models import lights as lights_mod
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.material import (
    BASE_MATERIAL_NOALPHA,
    BASE_MATERIAL_THIN,
)
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu_torch.models import sky as sky_mod
from realtimepathtracingresearchframework_tpu_torch.ops import nee as nee_mod
from realtimepathtracingresearchframework_tpu_torch.ops import aov as aov_mod
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
from realtimepathtracingresearchframework_tpu_torch.ops.integrator import (
    RAYS_PER_PASS,
    STREAM_CLOSEST,
    DeviceScene,
    FrameParams,
    IntegratorConfig,
    ViewBuffers,
    _closest_hit_dispatch,
    image_to_planes,
    make_pass_fn,
    pack_attr_table,
    pack_material_table,
    planes_to_image,
    render_debug_host,
    render_ray_stats_host,
    render_tile_host,
    tile_tables,
    trace_paths,
)
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu_torch.ops import raster as raster_mod
from realtimepathtracingresearchframework_tpu_torch.ops import resolve as resolve_mod
from realtimepathtracingresearchframework_tpu_torch.ops import shade as shade_mod
from realtimepathtracingresearchframework_tpu_torch.ops import taa as taa_mod
from realtimepathtracingresearchframework_tpu_torch.ops import texture_atlas
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_binned
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_flat import (
    pack_flat,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse import (
    map_rows_to_tris,
)
from realtimepathtracingresearchframework_tpu_torch.ops.traverse_resident import (
    pack_resident,
)
from realtimepathtracingresearchframework_tpu_torch.ops import tlas as tlas_mod
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_stream
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_tlas_stream,
)
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_v1
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3
from realtimepathtracingresearchframework_tpu_torch.ops.wavefront_host import (
    WavefrontExecutor,
)
from realtimepathtracingresearchframework_tpu_torch.kernels import build as build_mod
from realtimepathtracingresearchframework_tpu_torch.parallel.mesh import replicate
from realtimepathtracingresearchframework_tpu_torch.utils import debug as debug_mod
from realtimepathtracingresearchframework_tpu_torch.utils.error_io import warning
from realtimepathtracingresearchframework_tpu_torch.utils.profiling import (
    DeviceTimers,
    ProfilingMarker,
    fused_shade_share,
    host_read,
    host_sync,
    reset_shaded,
)

# resident-kernel policy (renderer.py:113-124, 605-608): the flat cull and
# the coherence sort from this many triangles, the resident kernels up to
# the node-table cap
V3_MIN_TRIS = 16_384
COMPACT_MIN_TRIS = 16_384
RESIDENT_MAX_TRIS = 90_000


# render variants (renderer.py:86-104): the wavefront and the two debug
# views have paths of their own, every other variant renders through the
# megakernel, and RQ_CLOSEST is a query kernel, not a frame renderer
VARIANT_MEGAKERNEL = "PT_MEGAKERNEL"
VARIANT_WAVEFRONT = "PT_WAVEFRONT"
VARIANT_PT = "PT"
VARIANT_TAIL_RECURSIVE = "PT_TAIL_RECURSIVE"
VARIANT_BTD_SHADE = "PT_BTD_SHADE"
VARIANT_STACK_RECURSIVE = "PT_STACK_RECURSIVE"
VARIANT_RTP_MEGAKERNEL = "PT_RTP_MEGAKERNEL"
VARIANT_RT_DEBUG = "RT_DEBUG"
VARIANT_GBUFFER = "GBUFFER"
VARIANT_RQ_CLOSEST = "RQ_CLOSEST"
# the registered variants in the reference's order (renderer.py:290-304)
VARIANTS = (
    VARIANT_TAIL_RECURSIVE, VARIANT_BTD_SHADE, VARIANT_STACK_RECURSIVE,
    VARIANT_MEGAKERNEL, VARIANT_RTP_MEGAKERNEL, VARIANT_PT,
    VARIANT_WAVEFRONT, VARIANT_RQ_CLOSEST, VARIANT_GBUFFER, VARIANT_RT_DEBUG,
)


def resident_leaf_size(num_tris: int) -> int:
    """Leaf size of the resident walk (renderer.py:844-847)."""
    return 32 if num_tris <= 24_000 else (64 if num_tris <= 48_000 else 128)


class Route(NamedTuple):
    """Traversal route of a scene (the reference's choices on a chip)."""

    kernel_v3: bool  # K2/K3 flat cull instead of the K1 walk
    compact: bool  # coherence-sorted dispatch past bounce 0
    leaf_size: int
    streamed: bool = False  # the streamed pack, K4 and K5
    tlas: str = ""  # two-level instancing: "k6" or "k7"
    v1: bool = False  # the v1 walk K8a/K8b (RPTR_TRAVERSAL_V1)


def _env_flag(name: str, default: bool) -> bool:
    """The reference's override convention: unset or empty keeps the
    default, "0" switches off, anything else on."""
    value = os.environ.get(name, "")
    return default if value == "" else value != "0"


def route_for(num_tris: int) -> Route:
    """The route the reference's renderer takes for a static, untextured
    scene of ``num_tris`` triangles on a chip (renderer.py:588-608,
    815-847), with its overrides. Above ``RESIDENT_MAX_TRIS``, or with
    ``RPTR_FORCE_STREAMED_TRAVERSAL`` set, the streamed route (K4/K5; no
    flat cull, no per-dispatch sort, no wavefront executor; V1 is ignored
    there, as in the reference). Otherwise ``RPTR_TRAVERSAL_V1`` (any
    non-empty value, as renderer.py:821-838 reads it) selects the v1
    walk K8a/K8b at leaf 128, winning over ``RPTR_TRAVERSAL_V3``,
    with the sort flag from 16,384 triangles (which the v1 dispatches
    ignore); else ``RPTR_TRAVERSAL_V3=1/0`` forces the flat cull on or
    off."""
    if os.environ.get("RPTR_FORCE_STREAMED_TRAVERSAL") or (
        num_tris > RESIDENT_MAX_TRIS
    ):
        return Route(kernel_v3=False, compact=False,
                     leaf_size=traverse_stream.LEAF, streamed=True)
    if os.environ.get("RPTR_TRAVERSAL_V1"):
        return Route(kernel_v3=False, compact=num_tris >= COMPACT_MIN_TRIS,
                     leaf_size=traverse_v1.LEAF, v1=True)
    v3 = os.environ.get("RPTR_TRAVERSAL_V3")
    return Route(
        kernel_v3=num_tris >= V3_MIN_TRIS if v3 is None else v3 != "0",
        compact=num_tris >= COMPACT_MIN_TRIS,
        leaf_size=resident_leaf_size(num_tris),
    )


def route_kernels(route: Route) -> List[str]:
    """The ``csrc/<name>.cu`` sources whose kernels a route launches (the
    names ``kernels/build.py`` builds): K1 on the resident route, K2 and K3
    on the flat cull, K4 and K5 streamed, K6 or K7 two-level, K8a/K8b
    (one source) under V1."""
    if route.tlas:
        return [traverse_tlas.KERNEL if route.tlas == "k6"
                else traverse_tlas_stream.KERNEL]
    if route.streamed:
        return [traverse_stream.KERNEL, traverse_binned.KERNEL]
    if route.v1:
        return [traverse_v1.KERNEL]
    if route.kernel_v3:
        return [traverse_flat.K2, traverse_flat.K3]
    return [traverse_resident.KERNEL]


@dataclass
class RenderStats:
    """librender/render_backend.h:15-24 (renderer.py:126-134)."""

    render_time: float = 0.0  # ms
    spp: int = 0
    rays_per_second: float = -1.0
    device_bytes_currently_allocated: int = 0
    max_device_bytes_allocated: int = 0
    total_device_bytes: int = 0


@dataclass
class FrameConfig:
    """Per-frame inputs (camera, params, scene config)."""

    camera: OrientedCamera = field(default_factory=OrientedCamera)
    params: RenderParams = field(default_factory=RenderParams)
    scene_config: SceneConfig = field(default_factory=SceneConfig)


class Renderer:
    """Render backend on one torch device, or on several
    (``devices``)."""

    # a frame's completion is waited for every this many frames (renderer.
    # py:141-144); in between, ``render`` returns without a sync
    SYNC_INTERVAL = 16

    def __init__(self, device="cuda", devices=None,
                 rays_per_pass: int = RAYS_PER_PASS):
        """``devices``: render across several devices (renderer.py:
        154-168). The planar frame's swizzle chunks go round-robin over
        them, chunk c on ``devices[c % n]`` with its own pass program and
        accumulators, each device on its own replica of the device scene
        (``parallel.mesh.replicate``: tensor leaves only). The image-domain
        frames, the AOV and ray-query passes, the count and debug images
        and the raster G-buffer run on the first device, as the reference's
        do. A device may repeat (``["cpu"] * 4``, or ``cuda:0`` on a
        machine with one card)."""
        self.devices = [torch.device(d) for d in (devices or [device])]
        for dev in self.devices:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"Renderer(device={str(dev)!r}): "
                    "torch.cuda.is_available() is False"
                )
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {dev}")
        self.device = self.devices[0]
        self._multi = len(self.devices) > 1
        # per-device replicas of device_scene and their copy memos
        self._device_scenes: List[Optional[DeviceScene]] = []
        self._replica_memos = [{} for _ in self.devices]
        self.rays_per_pass = int(rays_per_pass)
        self.options = RenderBackendOptions()
        self.fb_width = 0
        self.fb_height = 0
        self.scene: Optional[Scene] = None
        self.device_scene = None
        self.frame_id = 0  # accumulated samples (render_vulkan.cpp:2152)
        self.shot_offset = 0
        self._acc_chunks: Optional[List[tuple]] = None
        self._swizzle = None  # (px, py, valid) per-chunk device tensors
        self._num_lights = 0
        self._bin_size = None  # binned RIS selection's bin width, or None
        self._has_thin = False
        self._has_textures = False
        self._has_alpha = False
        self.active_variant = VARIANT_MEGAKERNEL
        self._route: Optional[Route] = None
        self._wavefront: Optional[WavefrontExecutor] = None
        self.setup_seconds = 0.0  # host build + pack + upload of the BVH
        self.tlas_update_seconds = 0.0  # the last set_animation_frame
        self._streamed_topo = None  # for the streamed refit
        self._topology = None  # the resident routes' BVH, for their refit
        self._flat = None  # the flattened scene of the current frame
        self._mat_table = None  # the scene's materials (set_scene)
        self._sky_key = self._sky = None  # the cooked sky and its inputs
        self.animation_update = ""  # "refit" or "rebuild": the last
        # set_animation_frame of a flattened scene
        self.lod_rebuilds = 0  # rebuilds for a change of LoD selection
        # percent of the last frame's shaded bounces that ran the fused
        # rptr.shade kernels (ops/shade.py; profiling.shaded_bounces)
        self.shade_fused_share = 0.0
        self._last_rays: List[torch.Tensor] = []
        self.live_profile: List[int] = []  # wavefront live lanes per bounce
        self._scene_config = SceneConfig()
        self._scene_frame = 0
        self._frame_events = None  # CUDA events around the last frame
        self._win_t0 = None  # several cards: the host-clock window's start
        self._window_closed = False  # several cards: a window has ended
        self._last_render_ms = 0.0
        # every sync_interval-th frame render() waits for the frame's end
        # (1: each call's stats carry that call's own frame time)
        self.sync_interval = self.SYNC_INTERVAL
        self._frames_since_sync = 0
        self._warmup: Optional[threading.Thread] = None  # warmup_async's
        self._warmup_error: Optional[BaseException] = None
        self._resolve_args = (0.0, -1)  # exposure, early tone mapping mode
        self._total_device_bytes = None
        self._prev_view: Optional[ViewBuffers] = None  # of the last AOV pass
        self._aovs: Optional[aov_mod.AOVs] = None
        self._debug_image: Optional[torch.Tensor] = None  # RT_DEBUG / GBUFFER
        # the accumulation lives in ONE of two forms (renderer.py:177-189):
        # the per-chunk channel buffers in swizzle order (the planar fast
        # path), or (H, W, 4) images (the image-domain paths); ``accum``
        # and ``framebuffer`` present images either way
        self._planar = True
        self._accum_img: Optional[torch.Tensor] = None
        self._fb_img: Optional[torch.Tensor] = None
        self._inv = None  # (H * W,) pixel -> swizzle slot on the device
        self._prev_depth: Optional[torch.Tensor] = None  # ACCUMULATE's
        # --freeze-frame: re-render the same sample sequence every frame
        # (frame_id pinned, render_vulkan.cpp:2152-2154)
        self.freeze_frame = False
        self.timers = DeviceTimers()
        # the LoD selection the scene was flattened with (renderer.py:
        # 674-690): None without LoD groups
        self._lod_signature = None
        self._lod_camera_pos = None
        self._lod_threshold = SceneConfig().lod_threshold
        # RenderExtension framework (librender/render_backend.h:126-154):
        # the pointset and binned-lights extensions attach by default;
        # processing steps are made on demand (renderer.py:214-228)
        self.extensions: List = ext_mod.create_default_extensions(self)
        self._processing_steps = {}
        self._last_config: Optional["FrameConfig"] = None
        self._last_upscale = 1
        self._frame_id_at_render = 0

    @property
    def device_scene(self) -> Optional[DeviceScene]:
        """The device scene on the first device."""
        return self._device_scene

    @device_scene.setter
    def device_scene(self, ds: Optional[DeviceScene]) -> None:
        """Set the scene and refresh every device's replica of it
        (renderer.py:1059-1064, 1925-1942): on several devices only the
        tensors that changed since the last refresh are copied (an
        animation frame's TLAS side, a refit BVH, new lights), and the
        host metadata (numpy arrays, ints; K7's static pack) is never
        moved."""
        self._device_scene = ds
        if not self._multi or ds is None:
            self._device_scenes = [ds] * len(self.devices)
            return
        self._device_scenes = [
            replicate(ds, dev, memo)
            for dev, memo in zip(self.devices, self._replica_memos)]

    # ------------------------------------------------------------------
    # RenderExtension framework (render_vulkan_extensions.cpp:16-84;
    # renderer.py:251-284)
    # ------------------------------------------------------------------

    def create_default_extensions(self) -> List:
        return ext_mod.create_default_extensions(self)

    def create_processing_step(self, step):
        return ext_mod.create_processing_step(self, step)

    def get_processing_step(self, step):
        """The processing step's extension, made and initialised once."""
        ext = self._processing_steps.get(step)
        if ext is None:
            ext = self.create_processing_step(step)
            if ext is not None:
                ext.initialize(self.fb_width, self.fb_height)
            self._processing_steps[step] = ext
        return ext

    def active_extensions(self) -> List:
        return [e for e in self.extensions if e.is_active_for(self.options)]

    def last_aovs(self):
        """The AOVs of the frame just rendered, rendered on demand."""
        if self._aovs is None and self._last_config is not None:
            self._aovs = self.render_aovs(self._last_config)
        return self._aovs

    def frame_id_at_last_render(self) -> int:
        return self._frame_id_at_render

    def last_upscale(self) -> int:
        return self._last_upscale

    def variants(self) -> List[str]:
        """The variant list in the reference's registration order
        (renderer.py:290-304)."""
        return list(VARIANTS)

    def supported_variants(self) -> List[str]:
        """Every registered variant but ``RQ_CLOSEST``, a query kernel
        (renderer.py:306-309)."""
        return [v for v in self.variants() if v != VARIANT_RQ_CLOSEST]

    def set_variant(self, name: str) -> bool:
        """Select the active integrator (renderer.py:311-321); an
        unsupported name falls back to the megakernel and returns False,
        as the reference does."""
        if name in self.supported_variants():
            self.active_variant = name
            return True
        warning("unsupported variant %s; falling back to %s", name,
                VARIANT_MEGAKERNEL)
        self.active_variant = VARIANT_MEGAKERNEL
        return False

    def initialize(self, fb_width: int, fb_height: int) -> None:
        """Framebuffer (re)allocation (render_vulkan.cpp:246-370), then each
        extension's ``initialize`` (renderer.py:323-335). Swizzle chunk c's
        tables and accumulators live on ``devices[c % n]``."""
        self.fb_width = int(fb_width)
        self.fb_height = int(fb_height)
        # the frame's tables on the first device (the image-domain path's)
        *first, self._inv = tile_tables(self.fb_width, self.fb_height,
                                        self.device,
                                        rays_per_pass=self.rays_per_pass)
        self._swizzle_first = tuple(first)
        n = len(self.devices)
        self._swizzle = tuple([t.to(self.devices[c % n]) for c, t in
                               enumerate(chunks)] for chunks in first)
        self._acc_chunks = self._zero_chunks()
        self._planar = True
        self._accum_img = self._fb_img = None
        self._wavefront = None
        self._debug_image = None
        self.frame_id = 0
        for ext in self.extensions:
            ext.initialize(self.fb_width, self.fb_height)
        for ext in self._processing_steps.values():
            if ext is not None:
                ext.initialize(self.fb_width, self.fb_height)

    def _zero_chunks(self) -> List[tuple]:
        """Fresh zero channel buffers, four per swizzle chunk."""
        return [tuple(torch.zeros_like(p, dtype=torch.float32)
                      for _ in range(4)) for p in self._swizzle[0]]

    # -- accumulation / framebuffer state (planar fast path or image) -----

    def _materialize(self, planes) -> torch.Tensor:
        """Whole-frame channel planes in swizzle order -> (H, W, 4) image
        on the device."""
        return torch.stack(list(planes))[:, self._inv].T.reshape(
            self.fb_height, self.fb_width, 4)

    @property
    def accum(self) -> Optional[torch.Tensor]:
        """The linear accumulation as an (H, W, 4) image on the device."""
        if self._planar:
            return (None if self._acc_chunks is None
                    else self._materialize(self._planes()))
        return self._accum_img

    @accum.setter
    def accum(self, value) -> None:
        self._accum_img = value
        self._planar = False

    @property
    def framebuffer(self) -> Optional[torch.Tensor]:
        """The sRGB display image, (H * u, W * u, 4) on the device."""
        if self._planar:
            if self._acc_chunks is None:
                return None
            exposure, tonemap = self._resolve_args
            return self._materialize(resolve_mod.resolve_channels(
                self._planes(), exposure, tonemap))
        return self._fb_img

    @framebuffer.setter
    def framebuffer(self, value) -> None:
        # the image-domain paths set accum first (which leaves planar mode)
        self._fb_img = value

    def set_scene(self, scene: Scene,
                  scene_config: SceneConfig = SceneConfig(),
                  frame: int = 0) -> None:
        """Scene upload (``_rebuild_scene``), then each extension's
        ``update_scene_from_backend`` (renderer.py:472-478). ``frame`` is
        the animation frame of the instance transforms."""
        self.scene = scene
        self._rebuild_scene(scene_config, frame=frame)
        for ext in self.extensions:
            ext.update_scene_from_backend(scene)

    def _rebuild_scene(self, scene_config: SceneConfig, frame: int = 0,
                       camera_pos=None) -> None:
        """Flatten ``self.scene`` at ``frame`` with the LoD levels that
        ``camera_pos`` selects (the base levels when None), then the BVH
        build + resident pack and attribute tables in BVH-row order, or the
        streamed pack and attribute tables in source-triangle order, or
        with ``options.use_tlas`` the two-level build and attribute tables
        in object-space mesh order; lights, sky and RNG tables
        (renderer.py:652-1068). The LoD selection, its camera and threshold
        are kept for ``render`` and ``set_animation_frame``
        (renderer.py:674-690)."""
        scene = self.scene
        self._scene_config = scene_config
        flat = scene.flatten_world(frame=frame, camera_pos=camera_pos,
                                   lod_threshold=scene_config.lod_threshold)
        self._lod_signature = (
            scene.lod_selection(camera_pos, scene_config.lod_threshold, frame)
            if scene.has_lod_groups() else None)
        self._lod_camera_pos = (None if camera_pos is None
                                else np.asarray(camera_pos, np.float32))
        self._lod_threshold = scene_config.lod_threshold
        dev = self.device
        self._scene_frame = frame
        shade, tlas, k6, k7 = flat, None, None, None
        self._tlas_build_seconds = 0.0
        if self.options.use_tlas:
            # attributes from the object-space flatten in source order;
            # the lights still come from the world flatten (renderer.py:769)
            shade, mesh_tris, *binding = scene.flatten_meshes()
        else:
            self._route = route = route_for(flat.num_tris)
        t0 = time.perf_counter()
        if self.options.use_tlas:
            tlas, k6, k7 = self._set_two_level(mesh_tris, binding, frame)
            self._route = route = Route(
                kernel_v3=False, compact=False, leaf_size=traverse_tlas.LEAF,
                tlas="k6" if k6 is not None else "k7")
            # hits carry global shading rows: attributes in source order
            bvh, ix = None, slice(None)
        elif route.streamed:
            if self.options.quantized_geometry:
                # 16-bit tiles (renderer.py:788-792): no refit topology
                bvh = traverse_stream.pack_streamed(
                    flat.v0, flat.e1, flat.e2, quantize=True, device=dev)
                self._streamed_topo = None
            else:
                bvh, self._streamed_topo = traverse_stream.pack_streamed(
                    flat.v0, flat.e1, flat.e2, with_topology=True, device=dev)
            # hits carry source triangle ids: attributes in source order
            ix = slice(None)
        else:
            # static scenes get the binned-SAH builder, animated ones the
            # fast Morton median split (renderer.py:855-859)
            animated = any(a.num_animated
                           for a in getattr(scene, "animation_data", []))
            builder = bvh_mod.build_bvh if animated else bvh_mod.build_bvh_sah
            self._topology = builder(flat.v0, flat.e1, flat.e2,
                                     leaf_size=route.leaf_size)
            bvh, ix = self._pack_resident_route(flat)
        self.setup_seconds = time.perf_counter() - t0
        self.timers.add(ProfilingMarker.BUILD_BLAS,
                        (self.setup_seconds - self._tlas_build_seconds) * 1e3)
        if route.streamed:
            print(f"set_scene: streamed pack of {flat.num_tris} tris into "
                  f"{bvh.num_subtrees} subtrees of {bvh.sub_leaves} leaves, "
                  f"{'int16' if bvh.quantized else 'f32'} tiles, in "
                  f"{self.setup_seconds:.2f} s", flush=True)
        if route.tlas:
            print(f"set_scene: two-level {route.tlas.upper()} route, "
                  f"{len(scene.instances)} instances of "
                  f"{len(self._mesh_tris)} meshes ({flat.num_tris} instanced "
                  f"tris), built and uploaded in {self.setup_seconds:.2f} s",
                  flush=True)
        mat_table = self._mat_table = scene.material_table()
        # the atlas (renderer.py:918-938): a 1-texel dummy without textures;
        # alpha-tested any-hit only where a textured material can cut
        atlas = texture_atlas.build_atlas(scene.textures, dev)
        self._has_textures = atlas is not None
        if atlas is None:
            atlas = texture_atlas.dummy_atlas(dev)
        self._has_alpha = self._has_textures and any(
            m.base_color_tex >= 0 and not (m.flags & BASE_MATERIAL_NOALPHA)
            for m in scene.materials
        )
        self._has_thin = any(m.flags & BASE_MATERIAL_THIN for m in scene.materials)

        mats = pack_material_table(mat_table).to(dev)
        self._flat = flat
        self._sky_key = None  # cook the sky anew for a new scene
        lights, sky, rng = self._scene_payload(flat, scene_config)
        self.device_scene = DeviceScene(
            bvh=bvh, attr_packed=self._attr_table(shade, ix), mat_packed=mats,
            lights=lights, sky=sky, tlas=tlas, tlas_k6=k6, tlas_stream=k7,
            atlas=atlas, rng=rng,
        )
        self._wavefront = None

    def _pack_resident_route(self, flat):
        """Thread ``self._topology`` over ``flat``'s triangles and pack it
        for the resident route's kernel (K1, K2/K3 or K8). Returns (the
        pack, the attribute index of each BVH row)."""
        route = self._route
        tb = bvh_mod.thread_bvh(self._topology, flat.v0, flat.e1, flat.e2)
        pack = (traverse_v1.pack_v1 if route.v1 else
                pack_flat if route.kernel_v3 else pack_resident)
        # attributes in BVH-row order: the kernel's row IS the attribute
        # index (padded rows clamp to a real tri and never win a hit)
        return (pack(tb, self.device),
                np.clip(np.asarray(tb.row_tri), 0, flat.num_tris - 1))

    def _attr_table(self, shade, ix) -> torch.Tensor:
        """The (ATTR_W, rows) attribute table of ``shade``'s triangles in
        the order ``ix`` (BVH rows, or source order), on the device."""
        rows = SimpleNamespace(**{
            name: np.asarray(getattr(shade, name))[ix]
            for name in ("e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                         "tangent", "texel_density", "material_id")
        })
        return pack_attr_table(rows, rows).to(self.device)

    def _scene_payload(self, flat, scene_config: SceneConfig):
        """The emitter tables of the posed flat scene, the sky and the RNG
        tables (renderer.py:961-1058). The active extensions contribute to
        the payload (extensions.py): under the RIS light-sampling variant
        the binned-lights extension re-lays a scene's emitters in bins of
        min(bucket count, emitter count) lights for binned RIS selection
        (``_bin_size``; ``_num_lights`` then counts the padded table), and
        the pointset extension of a table-based RNG variant builds its
        tables; without one the LCG's empty tables stand. The sky is cooked
        again only when its inputs change, as the reference caches it
        (renderer.py:985-1004)."""
        payload = {"emitters": lights_mod.collect_emitters(flat, self._mat_table),
                   "use_bins": False}
        for ext in self.active_extensions():
            ext.contribute_scene_payload(payload, scene_config)
        tl = payload["emitters"]
        use_bins = bool(payload["use_bins"]) and tl.count > 0
        self._bin_size = int(payload["bin_size"]) if use_bins else None
        rng = payload.get("rng")
        if rng is None:
            rng = pointsets.build_rng_buffers(RNG_VARIANT_UNIFORM,
                                              device=self.device)
        self._num_lights = tl.count
        if tl.count == 0:
            tl = lights_mod.empty_lights()
        lights = nee_mod.light_buffers(tl.v0, tl.v1, tl.v2, tl.radiance,
                                       self.device)
        key = (tuple(np.asarray(scene_config.sun_dir, np.float32).tolist()),
               float(scene_config.turbidity),
               tuple(np.asarray(scene_config.albedo, np.float32).ravel().tolist()),
               self._num_lights > 0)
        if key != self._sky_key:
            self._sky = sky_mod.build_sky(
                scene_config.sun_dir, scene_config.turbidity,
                scene_config.albedo, has_area_lights=self._num_lights > 0,
                device=self.device)
            self._sky_key = key
        return lights, self._sky, rng

    def _set_two_level(self, mesh_tris, binding, frame: int):
        """The two-level build of ``set_scene`` (renderer.py:692-769): the
        nested walk's BLAS set over the unique meshes (``mesh_tris``), and
        K6's 128-leaf BLASes when the scene is within its caps, else K7's
        chunk blocks at any entry count (rows past int32 raise
        ``ValueError``, checked from the mesh sizes before any chunk is
        built); then this frame's TLAS side. ``binding`` is (mesh id,
        material offset) per instance. Returns (TwoLevelBuffers, K6 buffers
        or None, K7 (static, frame) or None)."""
        mesh_ids = binding[0]
        self._mesh_tris = mesh_tris
        self._inst_binding = tuple(binding)
        self._blas = tlas_mod.build_blas_set(mesh_tris)
        self._blas_dev = tlas_mod.blas_tensors(self._blas, self.device)
        self._k6_static = self._k7_static = None
        if len(mesh_ids) <= traverse_tlas.MAX_INSTANCES:
            static = traverse_tlas.pack_blas(mesh_tris, self.device)
            if (static.blas_nodes.shape[0] + 2 * len(mesh_ids)
                    <= traverse_tlas.MAX_TOTAL_NODES):
                self._k6_static = static
        if self._k6_static is None:
            sizes = [len(m[0]) for m in mesh_tris]
            traverse_tlas_stream.check_rows(
                traverse_tlas_stream.entry_count(sizes, mesh_ids),
                traverse_tlas_stream.pick_chunk_tris(sizes))
            self._k7_static = traverse_tlas_stream.pack_tlas_stream_static(
                mesh_tris, device=self.device)
        t0 = time.perf_counter()
        out = self._build_tlas_buffers(self.scene.instance_transforms(frame))
        self._tlas_build_seconds = time.perf_counter() - t0
        self.timers.add(ProfilingMarker.BUILD_TLAS,
                        self._tlas_build_seconds * 1e3)
        return out

    def _build_tlas_buffers(self, transforms):
        """One frame's TLAS side (renderer.py:610-650): instance boxes, the
        TLAS, the instance tables and K6's or K7's frame pack, uploaded;
        the BLAS and chunk tensors are reused as they are. Returns
        (TwoLevelBuffers, K6 buffers or None, K7 (static, frame) or None)."""
        mesh_ids, mat_offsets = self._inst_binding
        dev = self.device
        aabbs = tlas_mod.instance_world_aabbs(self._blas, mesh_ids, transforms)
        nodes, row_inst = tlas_mod.build_tlas_nodes(aabbs)
        tables = tlas_mod.build_instance_tables(
            self._blas, mesh_ids, mat_offsets, transforms, dev)
        tb = tlas_mod.two_level_buffers(self._blas_dev, nodes, row_inst, tables)
        k6 = k7 = None
        if self._k6_static is not None:
            k6 = traverse_tlas.pack_two_level(
                self._k6_static, mesh_ids, self._blas.tri_base, nodes,
                row_inst, tables["inst_inv"].cpu().numpy(),
                tables["inst_cull_scale"].cpu().numpy())
        else:
            k7 = (self._k7_static, traverse_tlas_stream.pack_tlas_stream_frame(
                self._k7_static, mesh_ids, transforms, self._blas.tri_base))
        return tb, k6, k7

    def set_animation_frame(self, frame: int,
                            scene_config: Optional[SceneConfig] = None) -> None:
        """Re-pose the instances at an animation frame (renderer.py:
        1888-2060). On a two-level scene the TLAS, the instance tables and
        K6's or K7's frame pack are rebuilt on the host and uploaded; the
        BLAS and chunk tensors stay the same objects, and the lights and
        sky stay those of ``set_scene``, as there. A flattened scene is
        flattened at the frame and its BVH rebuilt or refit
        (``_animate_flattened``). Either way the accumulation restarts,
        a cached wavefront executor is dropped (it holds the old device
        scene), and ``tlas_update_seconds`` holds the update's host time.
        ``scene_config`` defaults to the one of ``set_scene``."""
        if self._route is None:
            raise RuntimeError("set_animation_frame before set_scene")
        if not self._route.tlas:
            self._animate_flattened(frame, scene_config or self._scene_config)
            return
        t0 = time.perf_counter()
        tb, k6, k7 = self._build_tlas_buffers(self.scene.instance_transforms(frame))
        self.device_scene = self.device_scene._replace(
            tlas=tb, tlas_k6=k6, tlas_stream=k7)
        self.tlas_update_seconds = time.perf_counter() - t0
        self.timers.add(ProfilingMarker.UPDATE_TLAS,
                        self.tlas_update_seconds * 1e3)
        self._scene_frame = frame
        self._wavefront = None
        self.frame_id = 0  # the next frame blends as the first sample

    def _animate_flattened(self, frame: int, scene_config: SceneConfig) -> None:
        """The flattened branch of set_animation_frame (renderer.py:
        1963-2060). On a scene with LoD groups the flatten reuses the
        selection the topology was built over (its camera and threshold),
        and a frame that changes that selection rebuilds the scene
        (``_rebuild_scene``, counted in ``lod_rebuilds``) instead of
        refitting. The scene is flattened at ``frame``; with ``options.force_bvh_rebuild`` or at
        most ``options.rebuild_triangle_budget`` triangles the BVH is
        rebuilt (the Morton builder on the resident routes, a full
        ``pack_streamed`` on the streamed one), else refit over its
        topology (``bvh.refit_bvh``, ``traverse_stream.refit_streamed``);
        a quantized streamed pack always repacks. The route's table is
        packed again (each leaf's real-row count with it), every
        row-ordered attribute re-indexed and the lights rebuilt from the
        posed scene, since emitters move too. ``tlas_update_seconds`` times
        the build or refit with its pack and upload (the reference's
        BUILD_TLAS / UPDATE_TLAS marker); ``animation_update`` says which
        ran. The reference re-uploads its device scene here through
        ``_upload_lights_and_sky``, which bumps its wavefront programs'
        cache key, so its executor is not stale on this branch; the port
        drops its executor."""
        scene = self.scene
        lod_cam, lod_thr = self._lod_camera_pos, self._lod_threshold
        if scene.has_lod_groups() and (
                scene.lod_selection(lod_cam, lod_thr, frame)
                != self._lod_signature):
            t0 = time.perf_counter()
            self._rebuild_scene(scene_config, frame=frame, camera_pos=lod_cam)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.tlas_update_seconds = time.perf_counter() - t0
            self.timers.add(ProfilingMarker.BUILD_TLAS,
                            self.tlas_update_seconds * 1e3)
            self.animation_update = "rebuild"
            self.lod_rebuilds += 1
            self.frame_id = 0
            return
        flat = scene.flatten_world(frame=frame, camera_pos=lod_cam,
                                   lod_threshold=lod_thr)
        rebuild = (self.options.force_bvh_rebuild
                   or flat.num_tris <= self.options.rebuild_triangle_budget)
        route, dev = self._route, self.device
        t0 = time.perf_counter()
        if route.streamed:
            if self.options.quantized_geometry:
                # fresh grids: a quantized pack keeps no refit topology
                bvh = traverse_stream.pack_streamed(
                    flat.v0, flat.e1, flat.e2, quantize=True, device=dev)
                rebuild = True
            elif rebuild or self._streamed_topo is None:
                bvh, self._streamed_topo = traverse_stream.pack_streamed(
                    flat.v0, flat.e1, flat.e2, with_topology=True, device=dev)
                rebuild = True
            else:
                bvh = traverse_stream.refit_streamed(
                    self._streamed_topo, flat.v0, flat.e1, flat.e2, device=dev)
            ix = slice(None)  # source order
        else:
            if rebuild:
                self._topology = bvh_mod.build_bvh(
                    flat.v0, flat.e1, flat.e2, leaf_size=route.leaf_size)
            else:
                self._topology = bvh_mod.refit_bvh(
                    self._topology, flat.v0, flat.e1, flat.e2)
            bvh, ix = self._pack_resident_route(flat)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.tlas_update_seconds = time.perf_counter() - t0
        self.timers.add(ProfilingMarker.BUILD_TLAS if rebuild
                        else ProfilingMarker.UPDATE_TLAS,
                        self.tlas_update_seconds * 1e3)
        self.animation_update = "rebuild" if rebuild else "refit"
        self._flat = flat
        lights, sky, rng = self._scene_payload(flat, scene_config)
        self.device_scene = self.device_scene._replace(
            bvh=bvh, attr_packed=self._attr_table(flat, ix), lights=lights,
            sky=sky, rng=rng)
        self._scene_frame = frame
        self._wavefront = None
        self.frame_id = 0  # the next frame blends as the first sample

    def _stream_closest_strategy(self) -> str:
        """``RPTR_STREAM_CLOSEST``, validated as renderer.py:1077-1089
        validates it: a typo raises ``ValueError``."""
        v = os.environ.get("RPTR_STREAM_CLOSEST", "sorted")
        if v not in STREAM_CLOSEST:
            raise ValueError(
                f"RPTR_STREAM_CLOSEST={v!r}: expected one of {STREAM_CLOSEST}")
        return v

    def _integrator_config(self, params: RenderParams) -> IntegratorConfig:
        """renderer.py:1104-1157 for the ported options. Carry compaction
        (``RPTR_COMPACT_LANES``, default on with the flat cull) is the
        monolith's, and the wavefront executor supersedes it; the per-
        dispatch sort (``RPTR_COMPACT``) defaults on from 16,384 triangles
        of a resident scene; ``RPTR_KERNEL_V4=0`` keeps the sorted queues
        on K2; ``RPTR_STREAM_CLOSEST`` picks the streamed closest-hit
        strategy. Textures and the alpha test follow the scene; anisotropic
        taps are off on two-level scenes, as there; the ``PT_WAVEFRONT``
        variant sets ``wavefront`` (renderer.py:1234-1235). Binned RIS
        light selection is on where the reference's binned-lights extension
        turns it on: the RIS variant and at least one emitter, with the bin
        width of ``_scene_payload`` (extensions.py:166-200, renderer.py:
        1116-1124). ``debug_mode`` stays 0: only ``render_debug_image``
        sets it, as in the reference (renderer.py:1643-1645)."""
        route = self._route
        # carry compaction of the monolith, on by default with the flat
        # cull (renderer.py:1105-1115)
        compact_lanes = _env_flag("RPTR_COMPACT_LANES",
                                  route.kernel_v3)
        use_bins = self._bin_size is not None
        return IntegratorConfig(
            two_level=bool(route.tlas),
            tlas_k6=route.tlas == "k6",
            tlas_stream=route.tlas == "k7",
            max_path_depth=int(params.max_path_depth),
            light_bin_size=(self._bin_size if use_bins else
                            int(self.options.light_sampling_bucket_count)),
            use_light_bins=use_bins,
            num_lights=int(self._num_lights),
            enable_sun_sky=True,
            rng_variant=int(self.options.rng_variant),
            has_transmission=True,  # kept on, as the reference keeps it
            thin_transmission=bool(self._has_thin),
            has_textures=bool(self._has_textures),
            alpha_test=bool(self._has_alpha),
            aniso_taps=0 if route.tlas else int(self.options.aniso_taps),
            wavefront=self.active_variant == VARIANT_WAVEFRONT,
            enable_dof=bool(self.options.enable_raytraced_dof)
            and float(params.aperture_radius) > 0.0,
            compact=_env_flag("RPTR_COMPACT", route.compact)
            and not compact_lanes,
            compact_lanes=compact_lanes,
            kernel_v3=route.kernel_v3,
            traversal_v1=route.v1,
            kernel_v4=route.kernel_v3
            and os.environ.get("RPTR_KERNEL_V4", "1") != "0",
            streamed=route.streamed,
            stream_closest=self._stream_closest_strategy(),
        )

    def _use_wavefront_host(self, cfg: IntegratorConfig) -> bool:
        """renderer.py:480-499: the bounce-major executor by default where
        the flat cull runs; ``RPTR_HOST_WAVEFRONT=1/0`` forces it. Never
        on several devices (its queue is frame-global), with debug
        counters, the wavefront variant or depth 1."""
        want = _env_flag("RPTR_HOST_WAVEFRONT",
                         self._route.kernel_v3)
        return (
            want
            and not self._multi
            and not cfg.debug_mode
            and not cfg.wavefront
            and cfg.max_path_depth > 1
            and self.device_scene is not None
        )

    def render(self, config: FrameConfig,
               batch_spp: Optional[int] = None) -> RenderStats:
        """One frame of ``batch_spp`` samples per pixel (renderer.py:
        1161-1519). A pending ``warmup_async`` is joined first, and its
        exception, if it raised one, is raised here. Returns ``stats()``
        once every pass is queued on the device: on a card the frame is
        timed by a pair of CUDA events around its queued work, read when it
        has completed, so the returned ``render_time`` is that of the last
        completed frame (the reference's delayed-timestamp design,
        renderer.py:1405-1436); every ``sync_interval``-th frame waits for
        its end event, so with ``sync_interval`` 1 each call returns its own
        frame's time. On several cards the host clock times each window of
        ``sync_interval`` frames, from the first frame's start to the end of
        every device's work, which the last frame waits for; the frame time
        is the window's mean, and before the first window ends the call's
        own wall. On the CPU the host clock times the call. The same
        times go to ``timers`` as RENDERING.

        On a scene with LoD groups, a camera whose LoD selection differs
        from the scene's rebuilds it first (``lod_rebuilds``) and restarts
        the accumulation. Without ACCUMULATE, TAA or an upscale the frame
        takes the planar fast path: each sample as one pass per chunk (or
        the wavefront executor's bounce-major passes), accumulated in place
        into the chunk buffers, resolved at the readback. Otherwise the
        image-domain path (``_render_image``). ``frame_id`` advances by
        the samples unless ``freeze_frame``."""
        self._join_warmup()
        if self.active_variant in (VARIANT_RT_DEBUG, VARIANT_GBUFFER):
            return self._render_debug_variant(config)
        self._debug_image = None
        reset_shaded()
        params = config.params
        spp = int(batch_spp if batch_spp is not None else params.batch_spp)
        sc = config.scene_config or SceneConfig()
        if self.scene is not None and self._lod_signature is not None:
            # re-flatten and rebuild only when the selected LoD set changes
            # (no thrash while the camera stays within a level's band)
            cam_pos = np.asarray(config.camera.pos, np.float32)
            sig = self.scene.lod_selection(cam_pos, sc.lod_threshold,
                                           self._scene_frame)
            if sig != self._lod_signature:
                self._rebuild_scene(sc, frame=self._scene_frame,
                                    camera_pos=cam_pos)
                self.lod_rebuilds += 1
                self.reset_accumulation()
        cuda = self._times_by_events()
        window = not cuda and self._times_by_window()
        t0 = time.perf_counter()
        self._read_frame_time(wait=False)  # the previous frame's, if done
        if cuda:
            events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            events[0].record()
        elif window and self._win_t0 is None:
            self._win_t0 = t0
        view = self._view(config.camera)
        fp = FrameParams(
            rr_path_depth=int(params.rr_path_depth),
            glossy_only_mode=int(params.glossy_only_mode),
            sample_offset=self.frame_id,
            shot_offset=self.shot_offset,
            pixel_radius=float(params.pixel_radius),
            bump_scale=float(sc.bump_scale),
            aperture_radius=float(params.aperture_radius),
            focus_distance=float(params.focus_distance),
        )
        cfg = self._integrator_config(params)
        # the state the processing extensions read (renderer.py:1237-1242)
        self._aovs = None
        self._last_config = config
        self._last_upscale = int(params.render_upscale_factor)
        self._frame_id_at_render = self.frame_id
        for ext in self.active_extensions():
            ext.preprocess()
        fast = (params.reprojection_mode != REPROJECTION_MODE_ACCUMULATE
                and not self.options.enable_taa
                and int(params.render_upscale_factor) == 1)
        if fast:
            self._render_planar(params, cfg, fp, view, spp)
        else:
            self._render_image(config, cfg, fp, view, spp)
        if cuda:
            events[1].record()
            self._frame_events = events
            self.timers.add_events(ProfilingMarker.RENDERING, *events)
            self._frames_since_sync += 1
            if self._frames_since_sync >= self.sync_interval:
                self._read_frame_time(wait=True)
                self._frames_since_sync = 0
        elif window:
            self._frames_since_sync += 1
            if self._frames_since_sync >= self.sync_interval:
                self._close_window()
            elif not self._window_closed:  # until then: the call's wall
                self._last_render_ms = (time.perf_counter() - t0) * 1e3
            self.timers.add(ProfilingMarker.RENDERING, self._last_render_ms)
        else:
            self._last_render_ms = (time.perf_counter() - t0) * 1e3
            self.timers.add(ProfilingMarker.RENDERING, self._last_render_ms)
        self.shade_fused_share = fused_shade_share()
        self.timers.end_frame()
        if not self.freeze_frame:
            self.frame_id += spp
        return self.stats()

    def _times_by_events(self) -> bool:
        """Frames are timed by CUDA events on one card, by the host clock on
        the CPU."""
        return self.device.type == "cuda" and not self._multi

    def _times_by_window(self) -> bool:
        """On several cards frames are timed by the host clock over each
        ``sync_interval`` window (``_close_window``): events on one card
        miss the others' work, and events of two cards cannot be
        subtracted."""
        return self._multi and any(d.type == "cuda" for d in self.devices)

    def _close_window(self) -> None:
        """End the host-clock window: wait for every device, then take the
        mean wall of the window's frames as the frame time (renderer.py:
        1405-1436)."""
        with host_sync("frame_event"):
            for dev in dict.fromkeys(self.devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        self._last_render_ms = ((time.perf_counter() - self._win_t0)
                                / self._frames_since_sync * 1e3)
        self._frames_since_sync = 0
        self._win_t0 = None
        self._window_closed = True

    def warmup_async(self, params: Optional[RenderParams] = None
                     ) -> threading.Thread:
        """The background pipeline build (renderer.py:532-590,
        render_vulkan.cpp:139-155): on a thread, build and load the
        libraries of the kernels the scene's route launches
        (``route_kernels``, and the fused shading kernels where
        ``shade.fused`` admits the configuration, through
        ``kernels/build.py``), then run one pass
        of chunk 0 at the frame size with ``params`` (default
        ``RenderParams()``) from the default camera into scratch buffers,
        on every device of the renderer (renderer.py:564-580).
        No sample reaches the accumulation, and ``frame_id`` and
        ``shot_offset`` stay as they are; the pass does count its kernel
        launches and its dropped NEE samples. Returns the started thread.
        The next ``render`` (or ray query, AOV or count-image pass) joins
        it before it launches anything, since the kernels launch on the
        calling thread's current stream, and raises the warm-up's
        exception if it failed."""
        self._join_warmup()  # one warm-up at a time
        params = params or RenderParams()
        cfg = self._integrator_config(params)
        # the route's walks, and the fused shading kernels where they shade
        names = route_kernels(self._route) + (
            [shade_mod.KERNEL] if shade_mod.fused(cfg) else [])
        scenes, devices = list(self._device_scenes), self.devices
        width, height = self.fb_width, self.fb_height
        chunk0 = [c[0] for c in self._swizzle]
        view = self._view(OrientedCamera())
        fp = FrameParams(rr_path_depth=int(params.rr_path_depth),
                         glossy_only_mode=int(params.glossy_only_mode),
                         sample_offset=0, shot_offset=0)

        def work():
            try:
                if any(d.type == "cuda" for d in devices):
                    build_mod.build_many(names)
                    for name in names:
                        build_mod.load(name)
                for ds, dev in zip(scenes, devices):
                    px, py, valid = (t.to(dev) for t in chunk0)
                    pass_fn = make_pass_fn(ds, cfg, width, height)
                    scratch = tuple(torch.zeros_like(px, dtype=torch.float32)
                                    for _ in range(4))
                    pass_fn(fp, replicate(view, dev), scratch, px, py, valid,
                            0, 0)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            except Exception as e:  # raised again by the joining call
                self._warmup_error = e

        self._warmup = threading.Thread(target=work, name="rptr-warmup",
                                        daemon=True)
        self._warmup.start()
        return self._warmup

    def _join_warmup(self) -> None:
        """Wait for a pending ``warmup_async``; raise its exception."""
        thread = self._warmup
        if thread is None:
            return
        thread.join()
        self._warmup = None
        error, self._warmup_error = self._warmup_error, None
        if error is not None:
            raise error

    def _check_pass(self, acc, s: int, c: int) -> None:
        """Under ``utils.debug.enable_nan_debugging``: the pass's chunk
        accumulators must be finite (a device sync)."""
        debug_mod.check_pass_finite(acc, self.frame_id, s, c)

    def _render_planar(self, params, cfg, fp, view, spp: int) -> None:
        """The planar fast path (renderer.py:1263-1440). An image history
        (a checkpoint, an image-domain frame) is re-swizzled into the chunk
        buffers first when samples are accumulated (renderer.py:
        1296-1331), and split over the devices. On several devices chunk c
        renders on ``devices[c % n]`` through that device's replica of the
        scene (renderer.py:1272-1295, 1366-1380)."""
        if not self._planar:
            if self.frame_id > 0 and self._accum_img is not None:
                planes = torch.from_numpy(image_to_planes(
                    self._accum_img.cpu().numpy(), self.fb_width,
                    self.fb_height, self.rays_per_pass))
                self._acc_chunks = [
                    tuple(p.contiguous().to(px.device) for p in ch.unbind(0))
                    for ch, px in zip(planes.split(
                        self._swizzle[0][0].shape[0], dim=1), self._swizzle[0])]
            else:
                self._acc_chunks = self._zero_chunks()
            self._planar = True
        # DISCARD_HISTORY (postprocess/reprojection.h:11-18): each frame
        # stands alone, blended as if the accumulator were empty
        discard = params.reprojection_mode == REPROJECTION_MODE_DISCARD_HISTORY
        base_k = 0 if discard else self.frame_id
        px_c, py_c, valid_c = self._swizzle
        rays = []
        if self._use_wavefront_host(cfg):
            wf = self._wavefront
            if wf is None or wf.cfg != cfg._replace(compact=False,
                                                    compact_lanes=False):
                wf = self._wavefront = WavefrontExecutor(
                    self.device_scene, cfg, self.fb_width, self.fb_height,
                    torch.cat(px_c), torch.cat(py_c), torch.cat(valid_c),
                    px_c[0].shape[0],
                )
            for s in range(spp):
                rays.append(wf.render_sample(fp, view, self._acc_chunks, s,
                                             base_k))
                for c, acc in enumerate(self._acc_chunks):
                    self._check_pass(acc, s, c)
            self.live_profile = wf.live_profile
        else:
            self.live_profile = []
            n = len(self.devices)
            pass_fns = [make_pass_fn(ds, cfg, self.fb_width, self.fb_height)
                        for ds in self._device_scenes]
            views = [view] + [replicate(view, d) for d in self.devices[1:]]
            for s in range(spp):
                for c, acc in enumerate(self._acc_chunks):
                    rays.append(pass_fns[c % n](fp, views[c % n], acc,
                                                px_c[c], py_c[c], valid_c[c],
                                                s, base_k))
                    self._check_pass(acc, s, c)
        self._last_rays = rays
        # the display resolve is deferred to the readback (renderer.py:
        # 1399-1404)
        self._resolve_args = (float(params.exposure),
                              int(params.early_tone_mapping_mode))

    def _render_image(self, config: FrameConfig, cfg, fp, view,
                      spp: int) -> None:
        """The image-domain frame (renderer.py:1442-1505): the frame's
        samples on fresh chunks through the monolithic pass, whatever the
        route would take on the fast path (renderer.py:1256-1262),
        assembled to an image; a planar history becomes the image history
        first (renderer.py:1448-1451). Then ACCUMULATE reprojects the
        history by this frame's motion AOV against the previous frame's
        depth, with the bounded window ``params.spp_accumulation_window``
        (a first frame, or one without a previous depth, stands alone);
        DISCARD_HISTORY keeps the frame alone; otherwise the history
        average. The display image is resolved at the upscale, and the TAA
        processing step runs on it (with the motion repeated by the
        upscale) under ``options.enable_taa``. On several devices all of it
        runs on the first (renderer.py:1442-1449)."""
        params = config.params
        pass_fn = make_pass_fn(self.device_scene, cfg, self.fb_width,
                               self.fb_height)
        new_accum, rays = render_tile_host(
            pass_fn, fp, view, self.fb_width, self.fb_height, spp,
            (*self._swizzle_first, self._inv),
            on_pass=self._check_pass if debug_mod.nan_debugging() else None)
        self.live_profile = []
        if self._planar:
            self.accum = self.accum  # leaving the fast path: image history
        if params.reprojection_mode == REPROJECTION_MODE_ACCUMULATE:
            aovs = self._aovs = self.render_aovs(config)
            prev_accum = self.accum
            depth = aovs.normal_depth[..., 3]
            if self._prev_depth is None or self.frame_id == 0:
                self.accum = new_accum
            else:
                self.accum = taa_mod.reproject_and_accumulate(
                    new_accum, prev_accum, aovs.motion_jitter[..., :2], depth,
                    self._prev_depth, int(params.spp_accumulation_window),
                    self.frame_id, spp)
            self._prev_depth = depth
        elif params.reprojection_mode == REPROJECTION_MODE_DISCARD_HISTORY:
            self.accum = new_accum
        else:
            self.accum = resolve_mod.accumulate_history(
                self.accum, new_accum, self.frame_id, spp)
        with self.timers.interval(ProfilingMarker.PROCESSING, self.device):
            self.framebuffer = resolve_mod.resolve_framebuffer(
                self.accum, float(params.exposure),
                int(params.early_tone_mapping_mode),
                int(params.render_upscale_factor))
        if self.options.enable_taa:
            taa_ext = self.get_processing_step(ext_mod.RenderProcessingStep.TAA)
            if taa_ext is not None and taa_ext.is_active_for(self.options):
                taa_ext.process()
        self._last_rays = rays

    def reset_accumulation(self) -> None:
        """The next frame blends as the first sample (renderer.py:1074)."""
        self.frame_id = 0

    def _validate_options(self, options):
        """(ok, adjusted): out-of-range options clamped to the supported
        lattice, the auto-adjust strategy of renderer.py:408-423."""
        adj = {}
        if not (0 <= options.rng_variant <= 3):
            adj["rng_variant"] = min(max(options.rng_variant, 0), 3)
        if not (1 <= options.light_sampling_bucket_count <= 64):
            adj["light_sampling_bucket_count"] = min(
                max(int(options.light_sampling_bucket_count), 1), 64)
        if options.render_upscale_factor < 1:
            adj["render_upscale_factor"] = 1
        if not (0 <= options.aniso_taps <= 16):
            adj["aniso_taps"] = min(max(int(options.aniso_taps), 0), 16)
        return (not adj), (options.replace(**adj) if adj else options)

    def configure_for(self, options) -> bool:
        """Apply options (renderer.py:425-470): invalid values are clamped
        to the supported lattice (then False is returned), and each
        extension active for them may clamp further
        (``normalize_options``, then False is returned) or refuse them
        (``configure_for``; then they are not applied and False is
        returned). A change of ``use_tlas`` or ``quantized_geometry``
        rebuilds the scene (``_rebuild_scene``) at its scene config,
        animation frame and LoD camera, since those options change what it
        builds; a change of ``rng_variant`` or of the light-sampling
        variant or bucket count alone rebuilds the scene's lights and RNG
        tables (``_scene_payload``). If the rebuild fails, the exception is
        logged, the renderer's last good state (options, scene, buffers) is
        restored and False is returned. Returns True iff the options
        applied unmodified."""
        ok, adjusted = self._validate_options(options)
        if not ok:
            warning("invalid render options; auto-adjusted to supported values")
        # extension option negotiation (app.cpp:391-396)
        for ext in self.extensions:
            if ext.is_active_for(adjusted):
                norm = ext.normalize_options(adjusted)
                if norm != adjusted:
                    adjusted, ok = norm, False
                if not ext.configure_for(adjusted):
                    return False
        if adjusted != self.options:
            rebuild = self.scene is not None and any(
                getattr(adjusted, f) != getattr(self.options, f)
                for f in ("use_tlas", "quantized_geometry"))
            last_good = dict(self.__dict__)  # options, scene and buffers
            try:
                rng_changed = adjusted.rng_variant != self.options.rng_variant
                lights_changed = any(
                    getattr(adjusted, f) != getattr(self.options, f)
                    for f in ("light_sampling_variant",
                              "light_sampling_bucket_count"))
                self.options = adjusted
                self._wavefront = None  # its programs hold the old options
                if rebuild:
                    self._rebuild_scene(self._scene_config,
                                        frame=self._scene_frame,
                                        camera_pos=self._lod_camera_pos)
                elif self.device_scene is not None and (rng_changed
                                                        or lights_changed):
                    lights, _, rng = self._scene_payload(self._flat,
                                                         self._scene_config)
                    self.device_scene = self.device_scene._replace(
                        lights=lights, rng=rng)
            except Exception as e:  # revert to the last good state
                warning("option apply failed (%r); reverting", e)
                self.__dict__.clear()
                self.__dict__.update(last_good)
                return False
        return ok

    def last_frame_rays(self) -> int:
        """Traced rays (closest + shadow) of the last frame; synchronises
        (renderer.py:1684-1692)."""
        return int(sum(int(r) for r in self._last_rays))

    def _read_frame_time(self, wait: bool) -> None:
        """Take the last frame's time from its CUDA events once its work
        has completed (``wait``: wait for it, ``host_read("frame_event")``);
        no host sync otherwise. On several cards ``wait`` ends the
        host-clock window early."""
        if self._times_by_window():
            if wait and self._frames_since_sync:
                self._close_window()
            return
        events = self._frame_events
        if events is None or not (wait or events[1].query()):
            return
        if wait:
            host_read("frame_event", events[1])
        self._last_render_ms = events[0].elapsed_time(events[1])
        self._frame_events = None

    def stats(self, force_rays: bool = False) -> RenderStats:
        """The reference's ``stats`` (renderer.py:1694-1733): the last
        completed frame's time, the accumulated samples, and the device
        allocator's current and peak bytes and the card's total (read once;
        0 on the CPU), of the first device on several, as the reference
        reads its first device.
        ``rays_per_second`` is -1 unless ``force_rays``, which reads the
        ray count and waits for the last frame."""
        self._read_frame_time(wait=force_rays)
        mem = peak = total = 0
        if self.device.type == "cuda":
            mem = torch.cuda.memory_allocated(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            if self._total_device_bytes is None:  # a runtime query: once
                self._total_device_bytes = torch.cuda.mem_get_info(
                    self.device)[1]
            total = self._total_device_bytes
        rps = -1.0
        if force_rays and self._last_render_ms > 0:
            rps = self.last_frame_rays() / (self._last_render_ms * 1e-3)
        return RenderStats(
            render_time=self._last_render_ms, spp=self.frame_id,
            rays_per_second=rps, device_bytes_currently_allocated=mem,
            max_device_bytes_allocated=peak, total_device_bytes=total)

    def _planes(self):
        """The accumulation's four channel planes over the whole frame, on
        the first device: on several devices the chunks are gathered there,
        the framebuffer all-gather of the reference (renderer.py:350-365)."""
        return [torch.cat([c[k].to(self.device) for c in self._acc_chunks])
                for k in range(4)]

    def readback_framebuffer(self) -> np.ndarray:
        """The sRGB display image (H * u, W * u, 4) float32 (renderer.py:
        1525-1552). On the planar path the accumulation is resolved by
        ``ops/resolve.py::resolve_channels`` with the last frame's
        ``params.exposure`` and ``early_tone_mapping_mode`` (renderer.py:
        1486-1488) on the device (PROCESSING), then un-swizzled on the host;
        on the image-domain path it is the frame's display image. After an
        ``RT_DEBUG`` or ``GBUFFER`` frame its image as it is. READBACK
        times the call on the host clock."""
        if self._debug_image is not None:
            return self._debug_image.cpu().numpy()
        t0 = time.perf_counter()
        if self._planar:
            exposure, tonemap = self._resolve_args
            with self.timers.interval(ProfilingMarker.PROCESSING, self.device):
                planes = resolve_mod.resolve_channels(self._planes(), exposure,
                                                      tonemap)
            out = planes_to_image(
                np.stack([p.cpu().numpy() for p in planes]), self.fb_width,
                self.fb_height, self.rays_per_pass)
        else:
            out = self._fb_img.cpu().numpy()
        self.timers.add(ProfilingMarker.READBACK,
                        (time.perf_counter() - t0) * 1e3)
        return out

    def readback_accumulation(self) -> np.ndarray:
        """Linear HDR accumulation buffer (H, W, 4) float32; after an
        ``RT_DEBUG`` or ``GBUFFER`` frame its image."""
        if self._debug_image is not None:
            return self._debug_image.cpu().numpy()
        if not self._planar:
            return self._accum_img.cpu().numpy()
        planes = np.stack([p.cpu().numpy() for p in self._planes()])
        return planes_to_image(
            planes, self.fb_width, self.fb_height, self.rays_per_pass
        )

    # ------------------------------------------------------------------
    # Checkpoint / resume (renderer.py:1656-1682)
    # ------------------------------------------------------------------

    def save_state(self, path: str) -> None:
        """Checkpoint the progressive render: the accumulation image and
        the sample bookkeeping, in the reference's ``.npz`` keys (accum,
        frame_id, shot_offset, fb_width, fb_height), so that either
        renderer resumes the other's checkpoint."""
        np.savez_compressed(
            path, accum=self.accum.cpu().numpy(), frame_id=self.frame_id,
            shot_offset=self.shot_offset, fb_width=self.fb_width,
            fb_height=self.fb_height)

    def load_state(self, path: str) -> None:
        """Resume a checkpointed accumulation (re-initialising at its size
        when it differs); ``render`` then adds samples from ``frame_id`` as
        an uninterrupted run would (the RNG seeds on the sample index)."""
        with np.load(path) as z:
            w, h = int(z["fb_width"]), int(z["fb_height"])
            if (w, h) != (self.fb_width, self.fb_height):
                self.initialize(w, h)
            self.accum = torch.from_numpy(
                np.ascontiguousarray(z["accum"], np.float32)).to(self.device)
            self.frame_id = int(z["frame_id"])
            self.shot_offset = int(z["shot_offset"])
        self.framebuffer = resolve_mod.resolve_framebuffer(self.accum, 0.0,
                                                           tonemap_mode=0)

    def _view(self, camera) -> ViewBuffers:
        """The camera's view basis on the device: one copy a buffer, each
        waiting for the device's queue (``host_sync("view_upload")``)."""
        bufs = []
        for a in camera.view_basis(self.fb_width, self.fb_height):
            with host_sync("view_upload"):
                bufs.append(torch.from_numpy(np.asarray(a, np.float32))
                            .to(self.device))
        return ViewBuffers(*bufs)

    # ------------------------------------------------------------------
    # Ray queries (render_vulkan.cpp:430-455, 1867-1877)
    # ------------------------------------------------------------------

    def render_ray_queries(self, origins: np.ndarray, dirs: np.ndarray,
                           t_max=None, variant: Optional[str] = None,
                           spp_per_query: int = 1,
                           params: Optional[RenderParams] = None):
        """The ray-query API (renderer.py:1734-1803).

        ``variant`` None or ``RQ_CLOSEST``: closest-hit queries
        (vulkan/rt_intersect.comp:31-68) through the scene's route kernel
        (K1, K2, K8, K4, K6 or K7, as the integrator dispatches a closest
        hit, without the alpha test), returning numpy (t, tri, u, v) with
        tri the source triangle (the global shading row on two-level
        scenes) and -1 on a miss. ``t_max`` is a scalar or one value per
        query (default 2e32).

        Any other variant of ``variants()``: the full integrator over the
        queries with ``spp_per_query`` samples each, the radiance capture
        path (``_render_integrator_queries``); returns (N, 4) float32 RGBA,
        alpha 1 where the path hit anything."""
        self._join_warmup()
        if variant not in (None, VARIANT_RQ_CLOSEST):
            return self._render_integrator_queries(
                origins, dirs, t_max, variant, spp_per_query, params)
        ro, rd = (self._soa(a) for a in (origins, dirs))
        tmax = torch.as_tensor(T_MAX if t_max is None else t_max,
                               dtype=torch.float32, device=self.device)
        cfg = self._integrator_config(RenderParams())
        hit = _closest_hit_dispatch(self.device_scene, cfg, ro, rd, 0.0, tmax)
        if not (self._route.streamed or self._route.tlas):
            hit = map_rows_to_tris(self.device_scene.bvh, hit)
        return (hit.t.cpu().numpy(), hit.tri.to(torch.int32).cpu().numpy(),
                hit.u.cpu().numpy(), hit.v.cpu().numpy())

    def _soa(self, a) -> Vec3:
        """(N, 3) numpy -> Vec3 on the device."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
        return Vec3(*(t[:, k].contiguous() for k in range(3)))

    def _render_integrator_queries(self, origins, dirs, t_max, variant: str,
                                   spp_per_query: int,
                                   params: Optional[RenderParams]):
        """Full-integrator ray queries (renderer.py:1805-1871): the queries
        padded to a multiple of 256 (of 8 up to 256 queries) with dead
        lanes, laid on a virtual sqrt screen for the RNG's pixel keying
        (render_vulkan.cpp:3050-3056), traced with the query's t_max
        bounding the primary segment, and averaged progressively per query
        over ``spp_per_query`` samples (accumulate.glsl:31-42)."""
        if variant not in self.variants():
            raise ValueError(f"unknown variant {variant!r}")
        params = params or RenderParams()
        # the monolithic pass; trace_paths turns carry compaction off for a
        # bounded primary segment (integrator.py:1607-1610)
        cfg = self._integrator_config(params)._replace(
            wavefront=variant == VARIANT_WAVEFRONT)
        n = len(origins)
        side = max(int(math.ceil(math.sqrt(n))), 1)
        pad = (-n) % 256 if n > 256 else (-n) % 8

        def padv(a, fill):
            a = np.asarray(a, np.float32)
            return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                              np.float32)])

        tmax_in = np.broadcast_to(
            np.asarray(T_MAX if t_max is None else t_max, np.float32), (n,))
        ro, rd = self._soa(padv(origins, 0.0)), self._soa(padv(dirs, 1.0))
        tmax = torch.from_numpy(padv(tmax_in, 0.0)).to(self.device)
        idx = torch.arange(n + pad, device=self.device)
        valid = idx < n
        px, py = (idx % side).to(torch.int32), (idx // side).to(torch.int32)
        acc = None
        for s in range(max(int(spp_per_query), 1)):
            fp = FrameParams(rr_path_depth=int(params.rr_path_depth),
                             glossy_only_mode=int(params.glossy_only_mode),
                             sample_offset=s, shot_offset=self.shot_offset)
            state = pointsets.make_state(cfg.rng_variant, s, fp.shot_offset,
                                         px, py, side,
                                         bufs=self.device_scene.rng)
            # the query rays take the camera's place; a lane past its
            # segment's end starts dead
            illum, alpha, _ = trace_paths(
                self.device_scene, cfg, fp, ro, rd, state,
                lane_mask=valid & (tmax > 0.0),
                t_max0=tmax if t_max is not None else None)
            res = torch.stack([illum.x, illum.y, illum.z, alpha], dim=-1)
            acc = res if acc is None else acc + (res - acc) / (s + 1.0)
        return acc[:n].cpu().numpy()

    # ------------------------------------------------------------------
    # AOVs (renderer.py:2085-2126)
    # ------------------------------------------------------------------

    # AOV buffer indices (util/display/render_graphic.h:12-18)
    AOV_ALBEDO_ROUGHNESS = 0
    AOV_NORMAL_DEPTH = 1
    AOV_MOTION_JITTER = 2

    def render_aovs(self, config: FrameConfig) -> aov_mod.AOVs:
        """The first-hit AOV pass (``ops/aov.py``) at the next sample's
        jitter; motion is taken against the previous call's view (the
        same view on the first call), which this call then replaces."""
        self._join_warmup()
        params = config.params
        view = self._view(config.camera)
        prev = self._prev_view if self._prev_view is not None else view
        fp = FrameParams(rr_path_depth=int(params.rr_path_depth),
                         glossy_only_mode=int(params.glossy_only_mode),
                         sample_offset=self.frame_id,
                         shot_offset=self.shot_offset)
        self._aovs = aov_mod.render_aovs(
            self.device_scene, self._integrator_config(params), fp, view,
            prev, self.fb_width, self.fb_height)
        self._prev_view = view
        return self._aovs

    def readback_aov(self, aov_index: int) -> np.ndarray:
        """One AOV buffer of the last ``render_aovs`` as an (H, W, 4)
        float32 array (render_graphic.h:40)."""
        if self._aovs is None:
            raise RuntimeError("render_aovs() has not been called")
        return self._aovs[aov_index].cpu().numpy()

    # ------------------------------------------------------------------
    # Debug views and count images (renderer.py:1565-1650)
    # ------------------------------------------------------------------

    def _render_debug_variant(self, config: FrameConfig) -> RenderStats:
        """The ``RT_DEBUG`` and ``GBUFFER`` views (renderer.py:1565-1587):
        first-hit images from the AOV pass. ``RT_DEBUG`` shows the shading
        normal as 0.5 n + 0.5 where the ray hit (alpha 1), 0 elsewhere;
        ``GBUFFER`` the albedo with the roughness in alpha. The image is
        the frame's accumulation and display image; one ray per pixel."""
        t0 = time.perf_counter()
        aovs = self.render_aovs(config)
        if self.active_variant == VARIANT_RT_DEBUG:
            n = aovs.normal_depth[..., :3]
            hit = aovs.normal_depth[..., 3:4] < 1.0e16
            fb = torch.cat([torch.where(hit, n * 0.5 + 0.5, 0.0),
                            torch.where(hit, 1.0, 0.0)], dim=-1)
        else:
            fb = aovs.albedo_roughness
        self._debug_image = fb
        self._frame_events = None
        self._last_render_ms = (time.perf_counter() - t0) * 1e3
        self._last_rays = [torch.tensor(self.fb_width * self.fb_height)]
        self.frame_id += 1
        return self.stats()

    def _count_frame_params(self, params: RenderParams) -> FrameParams:
        """The frame parameters of the count images: those the reference
        passes there (renderer.py:1605-1610), the others at their
        defaults."""
        return FrameParams(rr_path_depth=int(params.rr_path_depth),
                           glossy_only_mode=int(params.glossy_only_mode),
                           sample_offset=self.frame_id,
                           shot_offset=self.shot_offset)

    def render_ray_stats(self, config: FrameConfig) -> np.ndarray:
        """Per-pixel traced-ray count (closest + shadow) of one sample, the
        REPORT_RAY_STATS readback (renderer.py:1589-1615): the monolithic
        megakernel pass, whatever the variant. Returns (H, W) int32."""
        self._join_warmup()
        params = config.params
        cfg = self._integrator_config(params)._replace(wavefront=False)
        img = render_ray_stats_host(
            self.device_scene, cfg, self._count_frame_params(params),
            self._view(config.camera), self.fb_width, self.fb_height,
            self.rays_per_pass)
        return img.cpu().numpy()

    def render_debug_image(self, config: FrameConfig) -> np.ndarray:
        """The DEBUG_MODE_* image of one sample selected by
        ``options.debug_mode`` (renderer.py:1617-1650): any-hit (alpha
        test) evaluations over the full path or of primary visibility, or
        the bounce count per pixel, through the monolithic pass. Raises
        ``ValueError`` under DEBUG_MODE_OFF. Returns (H, W) int32."""
        self._join_warmup()
        if int(self.options.debug_mode) == 0:
            raise ValueError("options.debug_mode is DEBUG_MODE_OFF")
        params = config.params
        cfg = self._integrator_config(params)._replace(
            debug_mode=int(self.options.debug_mode), wavefront=False)
        img = render_debug_host(
            self.device_scene, cfg, self._count_frame_params(params),
            self._view(config.camera), self.fb_width, self.fb_height,
            self.rays_per_pass)
        return img.cpu().numpy()

    # ------------------------------------------------------------------
    # Raster G-buffer (renderer.py:2066-2084)
    # ------------------------------------------------------------------

    def render_raster_gbuffer(self, config: FrameConfig) -> raster_mod.GBuffer:
        """The optional raster G-buffer path (the ENABLE_RASTER pipeline):
        z-buffered albedo, shading normal, depth and triangle id of the
        renderer's flattened scene (``ops/raster.py``), without ray
        tracing; (H, W[, 3]) tensors on the device."""
        flat, dev = self._flat, self.device

        def t(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        pos, du, dv, tl = config.camera.view_basis(self.fb_width, self.fb_height)
        return raster_mod.raster_gbuffer(
            t(flat.v0), t(flat.e1), t(flat.e2), t(flat.n0), t(flat.n1),
            t(flat.n2), t(self._mat_table.base_color), t(flat.material_id,
                                                         np.int32),
            t(pos), t(du), t(dv), t(tl), self.fb_width, self.fb_height)

    # ------------------------------------------------------------------
    # Hot reload (renderer.py:2128-2182)
    # ------------------------------------------------------------------

    # the rendering modules eligible for hot reload, in dependency order
    # (leaves first, the integrator last): the analogue of the reference's
    # shader-source staleness check and recompile (gpu_programs.cpp:
    # 180-229). A module that imports another as a module object sees the
    # reload in place; the names this module imports from them are rebound
    # (``_HOT_RELOAD_NAMES``)
    _HOT_RELOAD_MODULES = (
        "ops.vec3", "ops.rng", "ops.sobol", "ops.pointsets_tables",
        "ops.pointsets", "ops.texture_atlas", "ops.bsdf_gltf",
        "ops.intersect", "ops.nee", "ops.resolve", "ops.taa", "ops.raster",
        "ops.traverse", "ops.traverse_resident", "ops.tlas",
        "ops.traverse_stream", "ops.traverse_binned", "ops.traverse_flat",
        "ops.traverse_tlas", "ops.traverse_tlas_stream", "ops.traverse_v1",
        "ops.aov", "ops.wavefront_host", "ops.integrator",
    )
    _HOT_RELOAD_NAMES = {
        "ops.vec3": ("Vec3",),
        "ops.intersect": ("T_MAX",),
        "ops.traverse": ("map_rows_to_tris",),
        "ops.traverse_resident": ("pack_resident",),
        "ops.traverse_flat": ("pack_flat",),
        "ops.wavefront_host": ("WavefrontExecutor",),
        "ops.integrator": (
            "RAYS_PER_PASS", "STREAM_CLOSEST", "DeviceScene", "FrameParams",
            "IntegratorConfig", "ViewBuffers", "_closest_hit_dispatch",
            "image_to_planes", "make_pass_fn", "pack_attr_table",
            "pack_material_table", "planes_to_image", "render_debug_host",
            "render_ray_stats_host", "render_tile_host", "tile_tables",
            "trace_paths"),
    }

    def hot_reload(self) -> bool:
        """Reload the edited rendering modules (renderer.py:2140-2182):
        the first call records each loaded module's source mtime; a later
        call reloads, in dependency order, every module from the first one
        whose source is newer, rebinds the names this module imported from
        them and drops the wavefront executor (its programs hold the old
        code). An edited ``csrc/*.cu`` or ``*.cuh`` is rebuilt at the next
        launch, since ``kernels/build.py`` keys each library by its
        sources' hash; the loaded libraries are dropped here so that the
        new one is loaded. Returns whether any module was reloaded."""
        import importlib
        import sys

        pkg = "realtimepathtracingresearchframework_tpu_torch"
        stale = False
        reloaded = []
        for rel in self._HOT_RELOAD_MODULES:
            mod = sys.modules.get(f"{pkg}.{rel}")
            if mod is None or not getattr(mod, "__file__", None):
                continue
            try:
                src_mtime = os.path.getmtime(mod.__file__)
            except OSError:
                continue
            loaded = getattr(mod, "__hot_mtime__", None)
            if loaded is None and not stale:
                mod.__hot_mtime__ = src_mtime
                continue
            if stale or (loaded is not None and src_mtime > loaded):
                importlib.reload(mod)
                mod.__hot_mtime__ = os.path.getmtime(mod.__file__)
                stale = True  # reload everything downstream of an edit
                reloaded.append(rel)
        g = globals()
        for rel in reloaded:
            for name in self._HOT_RELOAD_NAMES.get(rel, ()):
                g[name] = getattr(sys.modules[f"{pkg}.{rel}"], name)
        build_mod._loaded.clear()
        self._wavefront = None
        return stale
