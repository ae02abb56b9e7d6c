"""Application + scene state trees bound to ImState.

Mutable equivalents of the reference's UI/serialization state:
- :class:`ApplicationState`  ~ BasicApplicationState::state
  (libapp/app_state.cpp:13-201): target/accumulated spp, pause, batching,
  render options knobs, mode bookkeeping,
- :class:`SceneState` ~ BasicSceneState::state (libapp/scene_state.h:30-115):
  sensor (aperture/focus/focal length), tonemap + exposure, sun
  direction/turbidity/albedo, bump scale,
- :class:`CameraState` ~ camera_xi (libapp/camera_state.h:13-46).

All fields auto-serialize through app/imstate.py; `make_scene_id` builds
the per-scene target name ``Scene##<dir/file>`` (scene_state.h:117-132).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from realtimepathtracingresearchframework_tpu_torch.app.imstate import ImState
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import FrameConfig
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera


@dataclass
class CameraState:
    """camera_xi (libapp/camera_state.h:13-46)."""

    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 3.2]))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov: float = 65.0

    def to_camera(self) -> OrientedCamera:
        return OrientedCamera(
            pos=np.asarray(self.position, np.float64),
            dir=np.asarray(self.direction, np.float64),
            up=np.asarray(self.up, np.float64),
            fovy=float(self.fov),
        )


@dataclass
class SensorState:
    aperture_radius: float = 0.0
    focus_distance: float = 2.5
    focal_length: float = 35.0


@dataclass
class SunState:
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    turbidity: float = 3.0
    albedo: np.ndarray = field(default_factory=lambda: np.array([0.2, 0.2, 0.2]))


@dataclass
class SceneState:
    """BasicSceneState::state (libapp/scene_state.h:30-115)."""

    camera: CameraState = field(default_factory=CameraState)
    sensor: SensorState = field(default_factory=SensorState)
    sun: SunState = field(default_factory=SunState)
    exposure: float = 0.0
    tonemap_operator: int = -1
    bump_scale: float = 1.0


@dataclass
class ApplicationState:
    """BasicApplicationState::state (libapp/app_state.cpp:13-201)."""

    target_spp: int = 0  # 0 = unbounded progressive
    batch_spp: int = 1
    variant: str = ""  # selected renderer variant ("" = CLI/default); the
    # reference keeps the renderer selection in app state too
    # (app_state.cpp:117-143), so a viewer widget change persists
    max_path_depth: int = 9
    rr_path_depth: int = 2
    pause_rendering: bool = False
    continuous_restart: bool = False
    output_channel: int = 0
    render_upscale_factor: int = 1
    reprojection_mode: int = 0  # REPROJECTION_MODE_* (--reprojection)


def make_scene_id(scene_path: str) -> str:
    """Per-scene settings id ``Scene##<dir/file>`` (scene_state.h:117-132)."""
    norm = scene_path.replace("\\", "/")
    parts = [p for p in norm.split("/") if p]
    tail = "/".join(parts[-2:]) if len(parts) >= 2 else (parts[-1] if parts else "")
    return f"Scene##{tail}"


class AppStateBundle:
    """Registers the standard targets and converts to FrameConfig."""

    def __init__(self, ims: ImState, scene_path: str = ""):
        self.ims = ims
        self.app = ApplicationState()
        self.scene = SceneState()
        ims.register("Application Settings", self.app)
        ims.register("Scene", self.scene)
        if scene_path:
            ims.register(make_scene_id(scene_path), self.scene)

    def frame_config(self) -> FrameConfig:
        params = RenderParams(
            batch_spp=int(self.app.batch_spp),
            max_path_depth=int(self.app.max_path_depth),
            rr_path_depth=int(self.app.rr_path_depth),
            aperture_radius=float(self.scene.sensor.aperture_radius),
            focus_distance=float(self.scene.sensor.focus_distance),
            focal_length=float(self.scene.sensor.focal_length),
            output_channel=int(self.app.output_channel),
            exposure=float(self.scene.exposure),
            early_tone_mapping_mode=int(self.scene.tonemap_operator),
            render_upscale_factor=int(self.app.render_upscale_factor),
            reprojection_mode=int(self.app.reprojection_mode),
        )
        scene_config = SceneConfig(
            bump_scale=float(self.scene.bump_scale),
            sun_dir=tuple(float(x) for x in np.asarray(self.scene.sun.direction)),
            turbidity=float(self.scene.sun.turbidity),
            albedo=tuple(float(x) for x in np.asarray(self.scene.sun.albedo)),
        )
        return FrameConfig(
            camera=self.scene.camera.to_camera(),
            params=params,
            scene_config=scene_config,
        )
