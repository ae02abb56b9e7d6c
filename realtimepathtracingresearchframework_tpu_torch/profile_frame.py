"""Profile of one of the port's paths on one CUDA card.

``--scene cornell`` (default): the cornell box, the main path of
``chip_smoke.py``, through the monolithic pass and K1. ``--scene
terrain200``: ``procedural.terrain(grid=200)`` (80,000 triangles) with the
sun and sky of bench.py's terrain row, through the wavefront executor, K2
and K3. ``--scene terrain500``: ``procedural.terrain(grid=500)`` (500,000
triangles), same sun, sky and camera, on the streamed route: the
monolithic pass, K4 and K5 (``--quantized``: on 16-bit quantized tiles;
``RPTR_STREAM_CLOSEST=ordered|binned|multislot`` picks the closest-hit
strategy). ``--scene instanced600``, ``instanced500`` and
``instanced2500``: ``procedural.instanced_field(num_inst=600 | 500 |
2500)`` (601, 501 or 2,501 instances of four meshes) with the camera, sun
and sky of bench.py's instanced row, on the two-level route
(``options.use_tlas``): K7 past K6's 512-instance cap, K6 within it
(``RPTR_STREAM_CLOSEST=ordered``: K6's ordered instance walk); ``--animate`` updates the TLAS
(``set_animation_frame``) before every frame, as bench.py's row does;
``--flattened`` puts an instanced scene on the flattened route instead
(``options.use_tlas`` off: its BVH is refit or rebuilt by ``--animate``).
``--rng bn|sobol|zsbl`` picks the RNG variant (``options.rng_variant``),
``--ris`` binned RIS light selection, ``--aperture A [--focus F]``
thin-lens DoF. ``--accumulate`` (REPROJECTION_MODE_ACCUMULATE, window 8),
``--taa`` (``options.enable_taa``) and ``--upscale N``
(``render_upscale_factor``) put the frame on the image-domain path and
print the renderer's timers window (RENDERING, PROCESSING, TAA).
``--scene village``: ``procedural.village()`` (80,496 textured triangles)
with the camera, sun and sky of bench.py's village row, through K2, K3 and
the wavefront executor. ``--variant PT_WAVEFRONT`` renders through the
wavefront variant (on cornell: one merged K1 launch per bounce),
``RT_DEBUG`` and ``GBUFFER`` through the first-hit debug views, the other
variants through the megakernel.
``RPTR_TRAVERSAL_V1=1`` puts cornell, terrain40, terrain200 and the
village on the v1 route (the monolithic pass through K8a, or K8b past 8,192 padded rows;
merged K8 launches with ``--variant PT_WAVEFRONT``). At
``--size`` (default 1920x1080; bench.py's terrain and instanced rows are
``--size 512x384 --depth 3``), 1 spp, ``--depth`` (default 9): one warm-up
frame, ``--frames`` frames timed by the host clock with a device sync after
each, then ``--profiled`` frames under ``torch.profiler``. Prints the card's name, power limit and SM clock, the
scene's set-up seconds, the frame times, the device kernels per frame,
their summed time and the union of their intervals (the device busy share
is that union over the profiled wall), the traversal kernels' launches,
time and share of device time, the blocking host reads by site
(``utils.profiling.host_syncs``), the largest kernels, and the host's
launch and sync calls. The last line is a JSON summary.

    python -m realtimepathtracingresearchframework_tpu_torch.profile_frame \
        [--scene cornell|village|terrain200|terrain500|instanced600|instanced500|instanced2500] \
        [--variant PT_MEGAKERNEL|PT_WAVEFRONT|RT_DEBUG|...] [--animate] \
        [--quantized] [--flattened] [--rng uniform|bn|sobol|zsbl] [--ris] \
        [--aperture 0.05 --focus 3.2] [--accumulate] [--taa] [--upscale 2] \
        [--size 1920x1080] \
        [--depth 9] [--frames 5] [--profiled 3] [--out tables.txt]

``--out`` also writes torch.profiler's key-average tables to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    LIGHT_SAMPLING_VARIANT_RIS,
    REPROJECTION_MODE_ACCUMULATE,
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    VARIANT_MEGAKERNEL,
    VARIANT_RQ_CLOSEST,
    VARIANTS,
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.ops import integrator
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_binned as tb,
)
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_resident as tr,
)
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_stream as ts,
)
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas as tt
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_tlas_stream as tts,
)
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_v1 as tv
from realtimepathtracingresearchframework_tpu_torch.utils import profiling
from realtimepathtracingresearchframework_tpu_torch.utils.profiling import (
    ProfilingMarker,
)

SIZE = (1920, 1080)
# traversal kernels: the launch counter and a substring of the kernel name
KERNELS = {
    "K1": (lambda: tr.launches, "traverse_resident"),
    "K2": (lambda: tf.launches_k2, "flat_cull"),
    "K3": (lambda: tf.launches_k3, "precull"),
    "K4": (lambda: ts.launches_k4, "traverse_streamed"),
    "K5": (lambda: tb.launches_k5, "traverse_binned"),
    "K6": (lambda: tt.launches_k6, "traverse_tlas_kernel"),
    "K7": (lambda: tts.launches_k7, "traverse_tlas_stream"),
    "K8a": (lambda: tv.launches_k8a, "traverse_v1_kernel<true>"),
    "K8b": (lambda: tv.launches_k8b, "traverse_v1_kernel<false>"),
}
GRIDS = {"terrain40": 40, "terrain200": 200, "terrain500": 500}
INSTANCES = {"instanced600": 600, "instanced500": 500, "instanced2500": 2500}
RNG_NAMES = ("uniform", "bn", "sobol", "zsbl")  # options.rng_variant 0-3
ANIM_FRAMES = 16  # instanced_field's animation length
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaStreamSynchronize",
              "cudaMemcpyAsync", "aten::item")


def union_length(intervals) -> float:
    """Total length covered by a set of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total if cur_e is None else total + cur_e - cur_s


def frame_setup(scene: str, device="cuda", size=SIZE, depth: int = 9,
                grid: int = 200, num_inst: int = 600,
                variant: str = VARIANT_MEGAKERNEL, quantized: bool = False,
                use_tlas: bool = None, rng_variant: int = 0,
                ris: bool = False, aperture: float = 0.0, focus: float = None,
                devices=None):
    """(Renderer, FrameConfig) of a profiled path: ``"cornell"`` (camera of
    bench.py:91-99), ``"village"`` (``procedural.village(grid)``, sun, sky
    and camera of bench.py:101-113), ``"terrain"``
    (``procedural.terrain(grid)``, sun, sky and camera of bench.py:139-151)
    or ``"instanced"`` (``procedural.instanced_field(num_inst)`` on the
    two-level route, sun, sky and camera of bench.py:115-136), at ``size``,
    1 spp, ``depth``, through ``variant``; ``quantized`` packs a streamed
    scene's tiles as 16-bit codes (``options.quantized_geometry``).
    ``use_tlas=False`` flattens the instanced scene (the reference's
    default for an animated scene: its BVH is refit or rebuilt per frame);
    ``rng_variant`` is ``options.rng_variant``; ``ris`` selects binned RIS
    light selection (``options.light_sampling_variant``); ``aperture`` > 0
    turns on thin-lens DoF with that ``params.aperture_radius``, focused at
    ``focus`` (default ``RenderParams.focus_distance``); ``devices`` renders
    across several devices (``Renderer(devices=...)``)."""
    two_level = False
    if scene == "cornell":
        vkr_scene = procedural.cornell_box()
        cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
        sc = SceneConfig()
    elif scene == "village":
        vkr_scene = procedural.village(grid=grid)
        cam = OrientedCamera.look_at([0, 4.0, 13.0], [0, 0.5, 0], fovy=55)
        sc = SceneConfig(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)
    elif scene == "terrain":
        vkr_scene = procedural.terrain(grid=grid)
        cam = OrientedCamera.look_at([0, 5.0, 12.0], [0, 0, 0], fovy=55)
        sc = SceneConfig(sun_dir=(0.4, 0.7, 0.2), turbidity=3.0)
    elif scene == "instanced":
        vkr_scene = procedural.instanced_field(num_inst=num_inst)
        cam = OrientedCamera.look_at([0, 14.0, 30.0], [0, 0, 0], fovy=55)
        sc = SceneConfig(sun_dir=(0.4, 0.8, 0.25), turbidity=3.0)
        two_level = True if use_tlas is None else use_tlas
    else:
        raise KeyError(scene)
    r = Renderer(device=device, devices=devices)
    r.options = r.options.replace(use_tlas=two_level,
                                  quantized_geometry=quantized,
                                  rng_variant=int(rng_variant))
    if ris:
        r.options = r.options.replace(
            light_sampling_variant=LIGHT_SAMPLING_VARIANT_RIS)
    r.initialize(*size)
    r.set_scene(Scene.from_vkr_scene(vkr_scene), scene_config=sc)
    r.set_variant(variant)
    params = RenderParams(batch_spp=1, max_path_depth=depth,
                          aperture_radius=float(aperture))
    if focus is not None:
        params = params.replace(focus_distance=float(focus))
    cfg = FrameConfig(camera=cam, params=params, scene_config=sc)
    return r, cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("cornell", "village", *GRIDS, *INSTANCES),
                    default="cornell")
    ap.add_argument("--variant", default=VARIANT_MEGAKERNEL,
                    choices=[v for v in VARIANTS if v != VARIANT_RQ_CLOSEST])
    ap.add_argument("--animate", action="store_true",
                    help="update the TLAS before every frame (instanced scenes)")
    ap.add_argument("--quantized", action="store_true",
                    help="16-bit quantized tiles on the streamed route")
    ap.add_argument("--flattened", action="store_true",
                    help="an instanced scene without the two-level route")
    ap.add_argument("--rng", choices=RNG_NAMES, default="uniform")
    ap.add_argument("--ris", action="store_true",
                    help="binned RIS light selection")
    ap.add_argument("--aperture", type=float, default=0.0,
                    help="thin-lens DoF aperture radius (0: pinhole)")
    ap.add_argument("--focus", type=float, default=None,
                    help="thin-lens focus distance")
    ap.add_argument("--accumulate", action="store_true",
                    help="REPROJECTION_MODE_ACCUMULATE, window 8")
    ap.add_argument("--taa", action="store_true", help="options.enable_taa")
    ap.add_argument("--upscale", type=int, default=1,
                    help="render_upscale_factor")
    ap.add_argument("--size", default="1920x1080", help="WxH")
    ap.add_argument("--depth", type=int, default=9)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    size = tuple(int(x) for x in args.size.split("x"))
    common = dict(size=size, depth=args.depth, variant=args.variant,
                  rng_variant=RNG_NAMES.index(args.rng), ris=args.ris,
                  aperture=args.aperture, focus=args.focus)
    if args.scene in ("cornell", "village"):
        r, cfg = frame_setup(args.scene, **common)
    elif args.scene in INSTANCES:
        r, cfg = frame_setup("instanced", num_inst=INSTANCES[args.scene],
                             use_tlas=not args.flattened, **common)
    else:
        r, cfg = frame_setup("terrain", grid=GRIDS[args.scene],
                             quantized=args.quantized, **common)
    if args.animate and args.scene not in INSTANCES:
        ap.error("--animate needs an instanced scene")
    r.options = r.options.replace(enable_taa=args.taa)
    cfg = dataclasses.replace(cfg, params=cfg.params.replace(
        render_upscale_factor=args.upscale, spp_accumulation_window=8,
        **({"reprojection_mode": REPROJECTION_MODE_ACCUMULATE}
           if args.accumulate else {})))
    print(f"{args.scene} {args.size} depth {args.depth} {r.active_variant}: "
          f"set-up {r.setup_seconds:.3f} s, route {r._route}, textures "
          f"{r._has_textures}, alpha test {r._has_alpha}", flush=True)
    frame_no = 0
    updates = []

    def frame():
        """One frame, after a TLAS update with ``--animate``."""
        nonlocal frame_no
        if args.animate:
            frame_no += 1
            r.set_animation_frame(frame_no % ANIM_FRAMES)
            updates.append(r.tlas_update_seconds * 1e3)
        r.render(cfg)

    frame()  # warm-up
    torch.cuda.synchronize()

    walls = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    print(f"frame wall ms, no profiler: {walls}, median {wall_ms}", flush=True)
    if updates:
        print(f"TLAS update ms per frame (host build + upload): {updates}",
              flush=True)

    nf = args.profiled
    for mod in (tr, tf, ts, tb, tt, tts, tv):
        mod.reset_launches()
    integrator.reset_alpha_counts()
    integrator.reset_nee_dropped()
    profiling.reset_host_syncs()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nf):
            frame()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / nf
    launches = {k: count() / nf for k, (count, _) in KERNELS.items()}
    merged = {"K1": tr.merged_launches / nf, "K2": tf.merged_launches_k2 / nf,
              "K4": ts.merged_launches_k4 / nf, "K8": tv.merged_launches / nf}
    modes = {"K4 ordered": ts.launches_k4_ordered / nf,
             "K6 ordered": tt.launches_k6_ordered / nf,
             "K6 global": tt.launches_k6_global / nf,
             "K7 global": tts.launches_k7_global / nf,
             "multislot": tb.multislot_dispatches / nf}
    alpha = {"hops": integrator.alpha_hops / nf,
             "reads": profiling.host_syncs["alpha_cut"] / nf}
    syncs = {site: n / nf for site, n in sorted(profiling.host_syncs.items())}
    dropped = integrator.nee_dropped() / nf

    events = prof.events()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, host = {}, {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time, c + 1)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in HOST_CALLS:
            t, c = host.get(e.name, (0.0, 0))
            host[e.name] = (t + e.cpu_time_total, c + 1)
    device_ms = sum(t for t, _ in by_name.values()) / 1e3 / nf
    union_ms = union_length(
        (e.time_range.start, e.time_range.end) for e in kern) / 1e3 / nf
    kernel_ms = {
        k: sum(t for n, (t, _) in by_name.items() if sub in n) / 1e3 / nf
        for k, (_, sub) in KERNELS.items()
    }
    print(f"{args.scene}: profiled frame wall {prof_wall_ms:.3f} ms, device "
          f"kernels {len(kern) / nf:.0f} per frame, kernel time "
          f"{device_ms:.3f} ms, union {union_ms:.3f} ms, busy share of "
          f"profiled wall {union_ms / prof_wall_ms:.4f}")
    for k in KERNELS:
        print(f"  {k}: {launches[k]:.0f} launches, {kernel_ms[k]:.3f} ms per "
              f"frame, {kernel_ms[k] / device_ms:.4f} of device time")
    print(f"  merged two-queue launches per frame {merged}, modes per "
          f"frame {modes}, alpha test "
          f"per frame {alpha}, NEE samples dropped as non-finite per frame "
          f"{dropped}, blocking host reads per frame by site {syncs}")
    if r.live_profile:
        print(f"  live lanes per bounce (last frame): {r.live_profile}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / 1e3 / nf:9.3f} ms/frame {c / nf:8.0f} calls  {name[:100]}")
    for name, (t, c) in sorted(host.items()):
        print(f"  host {name}: {c / nf:.0f} per frame, {t / 1e3 / nf:.3f} ms/frame")
    timers = {m.value: r.timers.window_stats(m) for m in (
        ProfilingMarker.RENDERING, ProfilingMarker.PROCESSING,
        ProfilingMarker.TAA)}
    print(f"  timers window (avg, min, max, stddev) ms: {timers}")
    if args.out:
        ka = prof.key_averages()
        with open(args.out, "w") as f:
            f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40) + "\n")
            f.write(ka.table(sort_by="self_device_time_total", row_limit=40) + "\n")
    print(json.dumps({
        "scene": args.scene, "variant": r.active_variant, "size": args.size,
        "ris": args.ris, "aperture": args.aperture,
        "depth": args.depth, "quantized": args.quantized,
        "accumulate": args.accumulate, "taa": args.taa,
        "upscale": args.upscale, "timers": timers,
        "stream_closest": os.environ.get("RPTR_STREAM_CLOSEST", "sorted"),
        "merged_launches_per_frame": merged, "modes_per_frame": modes,
        "alpha_per_frame": alpha, "nee_dropped_per_frame": dropped,
        "host_syncs_per_frame": syncs,
        "animate": args.animate, "tlas_update_ms": updates,
        "setup_s": r.setup_seconds, "rays_per_frame": r.last_frame_rays(),
        "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
        "kernels_per_frame": len(kern) / nf, "device_ms": device_ms,
        "union_ms": union_ms, "busy_share_profiled": union_ms / prof_wall_ms,
        "launches_per_frame": launches, "kernel_ms": kernel_ms,
        "kernel_share_of_device": {
            k: kernel_ms[k] / device_ms for k in KERNELS
        },
        "live_per_bounce": r.live_profile,
        "host_launches_per_frame": host.get("cudaLaunchKernel", (0, 0))[1] / nf,
        "host_launch_ms": host.get("cudaLaunchKernel", (0, 0))[0] / 1e3 / nf,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
