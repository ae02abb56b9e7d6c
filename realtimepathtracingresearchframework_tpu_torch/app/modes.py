"""Headless run modes: validation, profiling, data capture.

Equivalent of the mode handling in ``libapp/app_state.cpp``:
- validation (app_state.cpp:228-233,269-274,464-481 and SURVEY section 3.3):
  time pinned to 0, per-frame batch spp clamped to hit the target exactly
  (app_state.h:90-94), framebuffer saved as ``<prefix>_%04d`` once done
  (or every spp step when target <= 0),
- profiling (app.cpp:223-229, app_state.cpp:300-305 and SURVEY section 3.4):
  fixed logical fps replay over keyframes, per-frame CSV row, optional
  per-keyframe image,
- data capture: AOV dumps per keyframe (app_state.cpp:499-530).

The port of the reference's ``app/modes.py`` over the port's ``Renderer``
(``readback_framebuffer``, ``readback_accumulation``, ``render_aovs``,
``readback_aov``, ``stats``). The profiling modes set
``Renderer.sync_interval`` to 1, so each CSV row's render time is that
frame's own (its CUDA events on a card).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from realtimepathtracingresearchframework_tpu_torch.app.benchmark import BenchmarkInfo
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.utils import image_io
from realtimepathtracingresearchframework_tpu_torch.utils.error_io import info

OUTPUT_IMAGE_FORMAT_EXR = "exr"
OUTPUT_IMAGE_FORMAT_PFM = "pfm"
OUTPUT_IMAGE_FORMAT_PNG = "png"


def save_framebuffer(prefix: str, renderer: Renderer, fmt: str) -> str:
    """Save per the reference's format selection (app_state.cpp:341-462):
    PNG saves the resolved sRGB display buffer; PFM/EXR save the linear HDR
    framebuffer (pre-sRGB)."""
    if fmt == OUTPUT_IMAGE_FORMAT_PNG:
        img = renderer.readback_framebuffer()
        path = prefix + ".png"
        image_io.write_png(path, np.clip(img, 0.0, 1.0))
    elif fmt == OUTPUT_IMAGE_FORMAT_PFM:
        img = renderer.readback_accumulation()
        path = prefix + ".pfm"
        image_io.write_pfm(path, img[..., :3])
    else:
        img = renderer.readback_accumulation()
        path = prefix + ".exr"
        image_io.write_exr_rgba(path, img, half=False)
    return path


def next_frame_spp(accumulated: int, target: int, batch: int) -> int:
    """Clamp the batch so accumulation hits the target exactly
    (libapp/app_state.h:90-94)."""
    if target <= 0:
        return batch
    return max(min(batch, target - accumulated), 0)


def run_validation(
    renderer: Renderer,
    config: FrameConfig,
    prefix: str,
    target_spp: int = 32,
    fmt: str = OUTPUT_IMAGE_FORMAT_PFM,
) -> List[str]:
    """Validation mode (SURVEY 3.3): accumulate to target_spp at time 0,
    save ``<prefix>_%04d`` images. target_spp <= 0 saves every batch."""
    renderer.reset_accumulation()
    saved = []
    accumulated = 0
    batch = max(config.params.batch_spp, 1)
    while True:
        spp = next_frame_spp(accumulated, target_spp, batch)
        if target_spp > 0 and spp == 0:
            break
        renderer.render(config, batch_spp=spp)
        accumulated += spp
        done = target_spp > 0 and accumulated >= target_spp
        if target_spp <= 0 or done:
            path = save_framebuffer(f"{prefix}_{accumulated:04d}", renderer, fmt)
            saved.append(path)
            info("validation: saved %s (%d spp)", path, accumulated)
        if done or (target_spp <= 0 and accumulated >= 1024):
            break
    return saved


def run_profiling_keyframed(
    renderer: Renderer,
    ims,
    bundle,
    prefix: str,
    fps: float = 60.0,
    save_keyframe_images: bool = False,
    fmt: str = OUTPUT_IMAGE_FORMAT_PFM,
    benchmark: Optional[BenchmarkInfo] = None,
    scene_config_cb=None,
) -> BenchmarkInfo:
    """Profiling mode over an imstate keyframe timeline (SURVEY 3.4):
    non-realtime fixed-fps time progression (app_state.cpp:300-305),
    keyframed settings applied when time passes their constraint
    (imstate.cpp:821-846), one CSV row per frame, exit when the last
    keyframe is reached (app_state.cpp:495-497)."""
    bi = benchmark or BenchmarkInfo()
    bi.open_csv(prefix + ".csv")
    ims.pad_frames(1)  # ensure >=1 keyframe pair (main.cpp:146-148)
    # each frame's own completed time for the CSV (the default interval
    # returns the last completed frame's, without a sync)
    prev_interval, renderer.sync_interval = renderer.sync_interval, 1
    try:
        t = 0.0
        dt = 1.0 / fps
        frames_accumulated = 0
        while True:
            if ims.have_new_settings(t):
                if save_keyframe_images and frames_accumulated > 0:
                    save_framebuffer(
                        f"{prefix}_kf{ims.current_keyframe():03d}",
                        renderer, fmt,
                    )
                ims.handled_new_settings()
                renderer.reset_accumulation()
                frames_accumulated = 0
                if scene_config_cb:
                    scene_config_cb(bundle)

            t0 = time.perf_counter()
            stats = renderer.render(bundle.frame_config())
            app_ms = (time.perf_counter() - t0) * 1e3
            frames_accumulated += 1
            bi.aggregate_frame(stats.render_time, app_ms)
            bi.write_csv(
                ims.current_keyframe(), frames_accumulated,
                stats.render_time, app_ms,
            )

            if ims.last_keyframe_coming_up(t) and not ims.have_new_settings(t):
                break
            t += dt
    finally:
        renderer.sync_interval = prev_interval
    if save_keyframe_images:
        save_framebuffer(f"{prefix}_kf{ims.current_keyframe():03d}", renderer, fmt)
    bi.close_csv()
    info(
        "profiling: %d frames, p50 render %.3f ms",
        bi.frames_total,
        bi.p50_render_time(),
    )
    return bi


def run_data_capture(
    renderer: Renderer,
    ims,
    bundle,
    prefix: str,
    target_spp: int = 16,
    rgba: bool = True,
    albedo_roughness: bool = True,
    normal_depth: bool = True,
    motion: bool = True,
    viewpoints: int = 0,
    viewpoint_seed: int = 0,
) -> List[str]:
    """Data-capture mode (denoiser training data): per keyframe, accumulate
    to target spp then dump rgba + AOV EXRs named
    <prefix>_%04d_{rgba,albedo_roughness,normal_depth,motion_jitter}
    (app_state.cpp:499-530).

    ``viewpoints > 0`` additionally generates that many POI-derived camera
    placements via ray queries (data_capture_state.h:18-86 semantics, see
    app/datacapture.py) and captures each of them after the keyframe
    timeline, named <prefix>_vp%02d_*."""
    saved = []
    ims.pad_frames(1)
    t = 0.0
    while True:
        if ims.have_new_settings(t):
            ims.handled_new_settings()
        renderer.reset_accumulation()
        config = bundle.frame_config()
        accumulated = 0
        batch = max(config.params.batch_spp, 1)
        while accumulated < target_spp:
            spp = next_frame_spp(accumulated, target_spp, batch)
            renderer.render(config, batch_spp=spp)
            accumulated += spp
        renderer.render_aovs(config)
        saved += _dump_capture(
            renderer, f"{prefix}_{ims.current_keyframe() + 1:04d}",
            rgba, albedo_roughness, normal_depth, motion,
        )
        # one capture per KEYFRAME: jump logical time straight to the
        # next settings frame's constraint (stepping by 1.0 re-rendered
        # and overwrote the same capture once per unit of keyframe gap)
        nxt = ims.next_settings_index
        if nxt >= ims.num_keyframes():
            break
        t = float(ims.settings[nxt].timeline_constraint)

    if viewpoints > 0:
        from realtimepathtracingresearchframework_tpu_torch.app.datacapture import (
            generate_capture_views,
        )
        from realtimepathtracingresearchframework_tpu_torch.models.camera import (
            OrientedCamera,
        )

        base = bundle.frame_config()
        views = generate_capture_views(
            renderer,
            [np.asarray(base.camera.pos, np.float32)],
            num_views=viewpoints,
            seed=viewpoint_seed,
        )
        for vi, v in enumerate(views):
            cam = OrientedCamera.look_at(
                v.pos, v.pos + v.dir, fovy=base.camera.fovy
            )
            config = bundle.frame_config()
            config.camera = cam
            renderer.reset_accumulation()
            accumulated = 0
            batch = max(config.params.batch_spp, 1)
            while accumulated < target_spp:
                spp = next_frame_spp(accumulated, target_spp, batch)
                renderer.render(config, batch_spp=spp)
                accumulated += spp
            renderer.render_aovs(config)
            saved += _dump_capture(
                renderer, f"{prefix}_vp{vi:02d}",
                rgba, albedo_roughness, normal_depth, motion,
            )
    info("data capture: wrote %d images", len(saved))
    return saved


def _dump_capture(renderer, pf, rgba, albedo_roughness, normal_depth, motion):
    saved = []
    if rgba:
        img = renderer.readback_accumulation()
        image_io.write_exr_rgba(pf + "_rgba.exr", img, half=False,
                                compression="none")
        saved.append(pf + "_rgba.exr")
    for flag, name, idx in (
        (albedo_roughness, "albedo_roughness", Renderer.AOV_ALBEDO_ROUGHNESS),
        (normal_depth, "normal_depth", Renderer.AOV_NORMAL_DEPTH),
        (motion, "motion_jitter", Renderer.AOV_MOTION_JITTER),
    ):
        if flag:
            aov = renderer.readback_aov(idx)
            image_io.write_exr_rgba(
                f"{pf}_{name}.exr", aov, half=False, compression="none"
            )
            saved.append(f"{pf}_{name}.exr")
    return saved


def run_profiling(
    renderer: Renderer,
    configs: List[FrameConfig],
    prefix: str,
    fps: float = 60.0,
    keyframe_times: Optional[List[float]] = None,
    save_keyframe_images: bool = False,
    fmt: str = OUTPUT_IMAGE_FORMAT_PFM,
    benchmark: Optional[BenchmarkInfo] = None,
) -> BenchmarkInfo:
    """Profiling mode (SURVEY 3.4): replay keyframed configs at a fixed
    logical fps (non-realtime), one CSV row per frame.

    ``configs`` holds one FrameConfig per keyframe; ``keyframe_times`` its
    start times (defaults to 1s apart). Rendering restarts accumulation at
    each keyframe like a settings change (app.cpp:312-336).
    """
    bi = benchmark or BenchmarkInfo()
    bi.open_csv(prefix + ".csv")
    prev_interval, renderer.sync_interval = renderer.sync_interval, 1
    try:
        if keyframe_times is None:
            keyframe_times = [float(i) for i in range(len(configs))]
        end_time = keyframe_times[-1] + (
            keyframe_times[-1] - keyframe_times[-2]
            if len(keyframe_times) > 1 else 1.0
        )

        t = 0.0
        ki = 0
        frames_accumulated = 0
        dt = 1.0 / fps
        while t < end_time:
            new_ki = max(
                [i for i, kt in enumerate(keyframe_times) if kt <= t],
                default=0,
            )
            if new_ki != ki:
                if save_keyframe_images:
                    save_framebuffer(f"{prefix}_kf{ki:03d}", renderer, fmt)
                ki = new_ki
                renderer.reset_accumulation()
                frames_accumulated = 0

            t0 = time.perf_counter()
            stats = renderer.render(configs[ki])
            app_ms = (time.perf_counter() - t0) * 1e3
            frames_accumulated += 1
            bi.aggregate_frame(stats.render_time, app_ms)
            bi.write_csv(ki, frames_accumulated, stats.render_time, app_ms)
            t += dt
    finally:
        renderer.sync_interval = prev_interval
    if save_keyframe_images:
        save_framebuffer(f"{prefix}_kf{ki:03d}", renderer, fmt)
    bi.close_csv()
    info(
        "profiling: %d frames, p50 render %.3f ms",
        bi.frames_total,
        bi.p50_render_time(),
    )
    return bi
