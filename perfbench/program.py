"""The system under test: the port's renderer, set up for one cell.

The only module of the benchmark that imports the port. It hands the input
scene (``perfbench/scenes``) to ``Renderer.set_scene``, with the render
options that the traffic mix sets (``"options"``, any field of
``RenderBackendOptions``), builds and loads the route's kernels, warms the
cell's own frame shape, and renders frames through ``Renderer.render``,
as the CLI's progressive render does (closed loop, one client, the
renderer's default ``sync_interval``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    LIGHT_SAMPLING_VARIANT_RIS,
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models.camera import (
    OrientedCamera,
)
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene

LIGHT_SELECTION = ("uniform", "ris")


class Program:
    """The port's renderer for one configuration and traffic mix."""

    def __init__(self, config: dict, traffic: dict, vs, device: str = "cuda",
                 log=print):
        if traffic["light_selection"] not in LIGHT_SELECTION:
            raise ValueError(f"light_selection {traffic['light_selection']!r}")
        if traffic.get("animation"):
            raise NotImplementedError("animated traffic has no generator yet")
        self.device = device
        self.phases = {}
        sun = config["sun"]
        self.scene_config = SceneConfig(sun_dir=tuple(sun["dir"]),
                                        turbidity=float(sun["turbidity"]))
        cam = config["camera"]
        self.frame = FrameConfig(
            camera=OrientedCamera.look_at(cam["eye"], cam["center"],
                                          fovy=cam["fovy"]),
            params=RenderParams(batch_spp=int(traffic["spp"]),
                                max_path_depth=int(traffic["max_depth"])),
            scene_config=self.scene_config)
        t0 = time.perf_counter()
        r = self.renderer = Renderer(device=device)
        r.options = r.options.replace(**traffic.get("options", {}))
        if traffic["light_selection"] == "ris":
            r.options = r.options.replace(
                light_sampling_variant=LIGHT_SAMPLING_VARIANT_RIS)
        r.initialize(int(traffic["width"]), int(traffic["height"]))
        r.set_scene(Scene.from_vkr_scene(vs), scene_config=self.scene_config)
        if not r.set_variant(traffic["variant"]):
            raise ValueError(f"variant {traffic['variant']!r} not supported")
        self._sync()
        self.phases["set_scene"] = time.perf_counter() - t0
        log(f"set_scene: route {r._route}, textures {r._has_textures}, alpha "
            f"test {r._has_alpha}, lights {r._num_lights}, program set-up "
            f"seconds {r.setup_seconds}")

    def _sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def load_kernels(self) -> None:
        """Build (first run in a checkout) and load the route's kernels,
        and run the renderer's own warm-up pass (``warmup_async``)."""
        t0 = time.perf_counter()
        self.renderer.warmup_async(self.frame.params).join()
        self._sync()
        self.phases["kernel_load"] = time.perf_counter() - t0

    def warm(self, frames: int) -> None:
        """``frames`` whole frames at the cell's shape, then a fresh
        accumulation: the window's first frame is sample 0."""
        t0 = time.perf_counter()
        for _ in range(frames):
            self.renderer.render(self.frame)
        self._sync()
        self.renderer.reset_accumulation()
        self.phases["warm_frames"] = time.perf_counter() - t0

    def set_shot(self, shot: int) -> None:
        """The frames' random sequence offset (``Renderer.shot_offset``)."""
        self.renderer.shot_offset = int(shot) & 0xFFFFFFFF

    def render(self) -> None:
        self.renderer.render(self.frame)

    def frames_accumulated(self) -> int:
        return int(self.renderer.frame_id)

    def rays_last_frame(self) -> int:
        """The last frame's traced rays (closest + shadow); synchronises."""
        return self.renderer.last_frame_rays()

    def spans(self) -> dict:
        """The renderer's own spans and counters, every number among its
        public attributes (``setup_seconds``: host build, pack and upload
        of the BVH; ``tlas_update_seconds``, ``lod_rebuilds``, ...), and
        the harness's set-up phases under ``phase.<name>``."""
        out = {k: float(v) for k, v in vars(self.renderer).items()
               if not k.startswith("_") and isinstance(v, (int, float))
               and not isinstance(v, bool)}
        out.update({f"phase.{k}": float(v) for k, v in self.phases.items()})
        return out

    def display(self, px: np.ndarray, py: np.ndarray) -> np.ndarray:
        """(K, 4) display values of the pixels (``readback_framebuffer``)."""
        img = self.renderer.readback_framebuffer()
        return img[np.asarray(py), np.asarray(px)]

    def close(self) -> None:
        self.renderer = None
