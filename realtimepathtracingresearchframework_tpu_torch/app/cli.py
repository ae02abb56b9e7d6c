"""Command line interface.

Flag-level parity with the reference CLI (cmdline.cpp:298-462): scene files
plus ``--img``, ``--upscale``, ``--config``, ``--frame``, ``--eye``,
``--center``, ``--up``, ``--fov``, ``--camera``, ``--device``
(``--vulkan-device`` alias), ``--disable-ui``, ``--freeze-frame``,
``--deduplicate-scene``, ``--backend``, ``--validation [--validation-spp]``,
``--profiling [--profiling-fps, --profiling-img]``, ``--data-capture``,
``--exr/--pfm/--png``, ``--resource-dir``, ``--spp``, ``--max-depth``.

Scenes: ``.vks`` paths, or builtin procedural names ``cornell`` /
``village`` / ``terrain[:grid]`` /
``triangle`` (the reference ships no assets; these drive the validation
configs of BASELINE.md).

The port of the reference's ``app/cli.py``: the same flags and load order
over the port's ``Renderer``. ``--backend cuda`` (the default) renders on
card ``--device`` and raises without one; ``--backend cpu`` runs each
kernel's plain version on the CPU. There is no fallback from one to the
other. ``--devices N`` above 1 renders on cards 0 to N - 1
(``Renderer(devices=...)``; more than ``torch.cuda.device_count()``
raises), or with ``--backend cpu`` on N replicas on the CPU. ``setup``
builds the scene, state and renderer for parsed arguments; ``main`` then
runs the mode. ``Renderer.warmup_async`` runs ahead of the interactive
viewer only, and is joined before ``main`` returns.

Run: ``python -m realtimepathtracingresearchframework_tpu_torch.app.cli
cornell [--disable-ui | --validation P | --profiling P | --data-capture P]``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.app import modes
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    LIGHT_SAMPLING_VARIANT_RIS,
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
    VARIANT_MEGAKERNEL,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.utils.error_io import info, throw_error


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rptr-torch",
        description="real-time path tracing research framework "
                    "(PyTorch/CUDA port)",
    )
    p.add_argument("scenes", nargs="*", help=".vks files or cornell|triangle")
    p.add_argument("--img", nargs=2, type=int, default=[1920, 1080], metavar=("W", "H"))
    # state-backed values default to None: an omitted flag must NOT
    # clobber what --config/--frame/adjacent-ini files loaded (the
    # dataclass defaults in app/state.py match the old CLI defaults)
    p.add_argument("--upscale", type=int, default=None)
    p.add_argument("--config", action="append", default=[], help="ini config file(s)")
    p.add_argument("--frame", action="append", default=[], help="keyframe ini file(s)")
    p.add_argument("--eye", nargs=3, type=float, default=None)
    p.add_argument("--center", nargs=3, type=float, default=None)
    p.add_argument("--up", nargs=3, type=float, default=None)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--camera", type=int, default=-1, help="scene camera index")
    p.add_argument("--device", "--vulkan-device", type=int, default=0)
    p.add_argument(
        "--devices", type=int, default=1,
        help="render across N cards (SURVEY 5.8); replicas with --backend cpu",
    )
    p.add_argument("--disable-ui", action="store_true")
    p.add_argument("--freeze-frame", action="store_true")
    p.add_argument("--deduplicate-scene", action="store_true")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="render device: CUDA card --device, or the CPU")
    p.add_argument("--variant", default=None,
                   help="renderer variant (default: ini state, else "
                        f"{VARIANT_MEGAKERNEL})")
    p.add_argument("--validation", default=None, metavar="PREFIX")
    p.add_argument("--validation-spp", type=int, default=32)
    p.add_argument("--profiling", default=None, metavar="PREFIX")
    p.add_argument("--profiling-fps", type=float, default=60.0)
    p.add_argument("--profiling-img", action="store_true")
    p.add_argument("--profiling-frames", type=int, default=120)
    p.add_argument("--data-capture", default=None, metavar="PREFIX")
    p.add_argument("--data-capture-spp", type=int, default=16)
    p.add_argument("--data-capture-no-rgba", action="store_true")
    p.add_argument("--data-capture-no-aovs", action="store_true")
    p.add_argument("--data-capture-albedo-roughness", action="store_true")
    p.add_argument("--data-capture-normal-depth", action="store_true")
    p.add_argument("--data-capture-motion", action="store_true")
    p.add_argument("--data-capture-viewpoints", type=int, default=0,
                   help="generate N POI-derived capture viewpoints")
    p.add_argument("--exr", action="store_true")
    p.add_argument("--pfm", action="store_true")
    p.add_argument("--png", action="store_true")
    p.add_argument("--resource-dir", default=None)
    p.add_argument("--spp", type=int, default=None, help="batch spp per frame")
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--rr-depth", type=int, default=None)
    p.add_argument("--exposure", type=float, default=None)
    p.add_argument("--light-sampling", choices=["none", "ris"], default="ris")
    p.add_argument(
        "--rng",
        choices=["uniform", "bn", "sobol", "z_sbl"],
        default="uniform",
        help="RNG pointset variant (RBO rng_variant)",
    )
    p.add_argument("--taa", action="store_true", help="enable TAA resolve")
    p.add_argument(
        "--aniso", type=int, default=0, metavar="TAPS",
        help="anisotropic texture filtering taps (0 = isotropic mip)",
    )
    p.add_argument(
        "--quantized-geometry", action="store_true",
        help="streamed path: 16-bit quantized leaf tiles decoded "
             "in-kernel (half the HBM footprint on large scenes)",
    )
    p.add_argument(
        "--use-tlas",
        action="store_true",
        help="two-level BLAS/TLAS instanced traversal (animation fast path)",
    )
    p.add_argument(
        "--reprojection",
        choices=["none", "discard", "accumulate"],
        default=None,
    )
    p.add_argument("--sun-dir", nargs=3, type=float, default=None)
    p.add_argument("--turbidity", type=float, default=None)
    return p


def load_scene(names, resource_dir=None) -> Scene:
    from realtimepathtracingresearchframework_tpu_torch.models.scene import (
        CameraDesc,
    )

    if not names:
        names = ["cornell"]
    paths = []
    scene = Scene()
    scene.animation_data = []
    for name in names:
        # procedural scenes ship their canonical viewpoint as a scene
        # camera (scene.h:60); .vks files carry none, like the reference
        if name == "cornell":
            scene.append_vkr_scene(procedural.cornell_box())
            scene.cameras.append(CameraDesc(
                position=np.array([0.0, 1.0, 3.2]),
                center=np.array([0.0, 1.0, 0.0]), fov_y=50.0,
            ))
        elif name == "triangle":
            scene.append_vkr_scene(procedural.single_triangle())
            scene.cameras.append(CameraDesc(
                position=np.array([0.0, 0.0, 3.0]),
                center=np.array([0.0, 0.0, 0.0]), fov_y=55.0,
            ))
        elif name == "village":
            scene.append_vkr_scene(procedural.village())
            scene.cameras.append(CameraDesc(
                position=np.array([0.0, 4.0, 13.0]),
                center=np.array([0.0, 0.5, 0.0]), fov_y=55.0,
            ))
        elif name.startswith("terrain"):
            grid = int(name.split(":", 1)[1]) if ":" in name else 500
            scene.append_vkr_scene(procedural.terrain(grid=grid))
            scene.cameras.append(CameraDesc(
                position=np.array([0.0, 5.0, 12.0]),
                center=np.array([0.0, 0.0, 0.0]), fov_y=55.0,
            ))
        else:
            path = name
            if resource_dir and not os.path.exists(path):
                path = os.path.join(resource_dir, name)
            if not os.path.exists(path):
                throw_error("scene file not found: %s", name)
            from realtimepathtracingresearchframework_tpu_torch.models import vkr

            scene.append_vkr_scene(vkr.open_scene(path))
    return scene


def setup(args):
    """The scene, the ini state and the renderer for parsed ``args``, in the
    reference's load order (its ``main`` up to the mode dispatch): the
    scene, its camera, the scene-adjacent ini, ``--config`` and ``--frame``
    files, the explicit flags, then the renderer on its device with the
    options and the scene uploaded. Returns (renderer, ims, bundle,
    config)."""
    scene = load_scene(args.scenes, args.resource_dir)
    if args.deduplicate_scene:
        scene.deduplicate()
    info("scene: %s", scene.info_string())

    # imstate config: scene-adjacent ini, --config files, --frame keyframes
    # (load order per main.cpp:93-150)
    from realtimepathtracingresearchframework_tpu_torch.app.imstate import ImState
    from realtimepathtracingresearchframework_tpu_torch.app.state import AppStateBundle

    ims = ImState()
    bundle = AppStateBundle(ims, args.scenes[0] if args.scenes else "")
    # scene-provided camera seeds the state BEFORE inis/flags override
    # (scene_state.cpp:45-49: applies only without explicit camera args)
    got_camera_args = any(
        x is not None for x in (args.eye, args.center, args.up, args.fov)
    )
    cam_id = max(args.camera, 0)
    if not got_camera_args and cam_id < len(scene.cameras):
        desc = scene.cameras[cam_id]
        bundle.scene.camera.position = np.asarray(desc.position, np.float64)
        d = np.asarray(desc.center, np.float64) - np.asarray(
            desc.position, np.float64
        )
        bundle.scene.camera.direction = d / np.linalg.norm(d)
        bundle.scene.camera.up = np.asarray(desc.up, np.float64)
        bundle.scene.camera.fov = float(desc.fov_y)
    for path in args.scenes:
        adj = os.path.splitext(path)[0] + ".ini"
        if os.path.exists(adj):
            ims.load_ini(adj)
    for path in args.config:
        ims.load_ini(path)
    for path in args.frame:
        ims.load_ini(path)
    ims.apply_base()

    # explicit CLI flags override config/state; omitted flags keep
    # whatever the ini files loaded (or the dataclass defaults — the
    # old CLI defaults — when nothing was loaded)
    if args.eye is not None:
        bundle.scene.camera.position = np.asarray(args.eye, np.float64)
    if args.center is not None:
        pos = np.asarray(bundle.scene.camera.position, np.float64)
        d = np.asarray(args.center, np.float64) - pos
        bundle.scene.camera.direction = d / np.linalg.norm(d)
    if args.up is not None:
        bundle.scene.camera.up = np.asarray(args.up, np.float64)
    if args.fov is not None:
        bundle.scene.camera.fov = args.fov
    if args.sun_dir is not None:
        bundle.scene.sun.direction = np.asarray(args.sun_dir, np.float64)
    if args.turbidity is not None:
        bundle.scene.sun.turbidity = args.turbidity
    if args.exposure is not None:
        bundle.scene.exposure = args.exposure
    if args.spp is not None:
        bundle.app.batch_spp = args.spp
    if args.max_depth is not None:
        bundle.app.max_path_depth = args.max_depth
    if args.rr_depth is not None:
        bundle.app.rr_path_depth = args.rr_depth
    if args.upscale is not None:
        bundle.app.render_upscale_factor = args.upscale
    if args.reprojection is not None:
        bundle.app.reprojection_mode = (
            ["none", "discard", "accumulate"].index(args.reprojection)
        )
    camera = bundle.scene.camera.to_camera()

    if args.devices > 1:
        if args.backend == "cuda":
            avail = torch.cuda.device_count()
            if args.devices > avail:
                throw_error(
                    "--devices %d but only %d devices available",
                    args.devices, avail,
                )
            devices = [f"cuda:{i}" for i in range(args.devices)]
        else:  # replicas on the CPU, as the reference's virtual devices
            devices = ["cpu"] * args.devices
        renderer = Renderer(devices=devices)
    else:
        renderer = Renderer(
            device=f"cuda:{args.device}" if args.backend == "cuda" else "cpu"
        )
    # explicit --variant wins, else the ini-persisted viewer selection
    # (app/state.py ApplicationState.variant), else the megakernel
    renderer.set_variant(
        args.variant or bundle.app.variant or VARIANT_MEGAKERNEL
    )
    bundle.app.variant = renderer.active_variant
    # params + scene config come from the state bundle (ini-loaded
    # values with CLI overrides applied above) — one source of truth
    # shared with the viewer/profiling/data-capture paths
    base = bundle.frame_config()
    opts = renderer.options.replace(
        render_upscale_factor=int(bundle.app.render_upscale_factor),
        light_sampling_variant=(
            LIGHT_SAMPLING_VARIANT_RIS if args.light_sampling == "ris" else 0
        ),
        rng_variant=["uniform", "bn", "sobol", "z_sbl"].index(args.rng),
        enable_taa=args.taa,
        use_tlas=args.use_tlas,
        aniso_taps=args.aniso,
        quantized_geometry=args.quantized_geometry,
    )
    renderer.options = opts
    renderer.freeze_frame = bool(args.freeze_frame)
    renderer.initialize(args.img[0], args.img[1])
    renderer.set_scene(scene, base.scene_config)

    config = FrameConfig(
        camera=camera, params=base.params, scene_config=base.scene_config
    )
    return renderer, ims, bundle, config


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    fmt = modes.OUTPUT_IMAGE_FORMAT_EXR
    if args.pfm:
        fmt = modes.OUTPUT_IMAGE_FORMAT_PFM
    if args.png:
        fmt = modes.OUTPUT_IMAGE_FORMAT_PNG
    if args.validation and not (args.exr or args.png):
        fmt = modes.OUTPUT_IMAGE_FORMAT_PFM  # README documents .pfm validation

    renderer, ims, bundle, config = setup(args)
    params = config.params
    if args.validation:
        modes.run_validation(
            renderer, config, args.validation, args.validation_spp, fmt
        )
        return 0

    if args.data_capture:
        # AOV selection per the reference flags (cmdline.cpp:428-448):
        # default all on; --data-capture-no-aovs drops them unless
        # individually re-enabled
        any_sel = (args.data_capture_albedo_roughness
                   or args.data_capture_normal_depth
                   or args.data_capture_motion)
        base = not (args.data_capture_no_aovs or any_sel)
        modes.run_data_capture(
            renderer, ims, bundle, args.data_capture,
            target_spp=max(args.data_capture_spp, 1),
            rgba=not args.data_capture_no_rgba,
            albedo_roughness=base or args.data_capture_albedo_roughness,
            normal_depth=base or args.data_capture_normal_depth,
            motion=base or args.data_capture_motion,
            viewpoints=args.data_capture_viewpoints,
        )
        return 0

    if args.profiling:
        # register CSV-source extensions (app.cpp:223-229): the
        # profiling-tools extension adds 32-frame-window marker columns
        from realtimepathtracingresearchframework_tpu_torch.app.benchmark import (
            BenchmarkInfo,
        )
        from realtimepathtracingresearchframework_tpu_torch.backend.extensions import (
            RenderProcessingStep,
        )

        bi = BenchmarkInfo()
        prof_ext = renderer.get_processing_step(
            RenderProcessingStep.PROFILING_TOOLS
        )
        if prof_ext is not None:
            bi.register_source(prof_ext)
        if args.frame or args.config:
            # keyframed replay from the loaded ini timeline (SURVEY 3.4)
            modes.run_profiling_keyframed(
                renderer,
                ims,
                bundle,
                args.profiling,
                fps=args.profiling_fps,
                save_keyframe_images=args.profiling_img,
                fmt=fmt,
                benchmark=bi,
            )
            return 0
        # no timeline given: synthesize a small camera orbit
        n_keyframes = 3
        cams = []
        for i in range(n_keyframes):
            c = bundle.scene.camera.to_camera()
            c.rotate(yaw_rad=0.15 * i)
            cams.append(FrameConfig(camera=c, params=params))
        times = [
            i * args.profiling_frames / args.profiling_fps / n_keyframes
            for i in range(n_keyframes)
        ]
        modes.run_profiling(
            renderer,
            cams,
            args.profiling,
            fps=args.profiling_fps,
            keyframe_times=times,
            save_keyframe_images=args.profiling_img,
            fmt=fmt,
            benchmark=bi,
        )
        return 0

    if not args.disable_ui:
        # default mode: interactive viewer (main.cpp run_app loop; the
        # display is a localhost web canvas on headless hosts)
        from realtimepathtracingresearchframework_tpu_torch.app.viewer import (
            InteractiveViewer,
        )

        # async pipeline warmup (render_vulkan.cpp:139-155): overlap the
        # kernels' build and load and a first pass with the viewer's
        # start — only ahead of the interactive viewer; the other modes
        # render at once, and their first frame would only wait for it.
        # The viewer's first frame joins it; joined again on the way out.
        warmup_thread = renderer.warmup_async(params)
        app_ini = os.path.expanduser("~/.rptr_tpu.ini")
        viewer = InteractiveViewer(
            renderer, bundle, ims,
            port=int(os.environ.get("RPTR_VIEWER_PORT", "8421")),
            app_ini=app_ini,
        )
        try:
            viewer.run()
        finally:
            warmup_thread.join(timeout=600)
        return 0

    # --disable-ui headless single-shot: render batch and save once
    renderer.render(config)
    stats = renderer.stats(force_rays=True)
    info(
        "rendered %dx%d @ %d spp in %.2f ms (%.2f Mrays/s)",
        args.img[0],
        args.img[1],
        int(bundle.app.batch_spp),
        stats.render_time,
        stats.rays_per_second / 1e6,
    )
    modes.save_framebuffer("out", renderer, fmt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
