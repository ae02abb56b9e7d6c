"""Kernel-only times of K1, K2 and K3 beside another checkout's build of
them, on one CUDA card, in one process.

    python -m realtimepathtracingresearchframework_tpu_torch.kernel_ab \\
        --other DIR [--rounds 2] [--iters 50]

``DIR`` is the root of another checkout of this repository (an older
commit unpacked with ``git archive``, say). Its
``csrc/traverse_resident.cu`` (K1), ``csrc/traverse_flat_cull.cu`` (K2) and
``csrc/traverse_precull.cu`` (K3), with that checkout's headers, are built
with this checkout's nvcc flags
into ``DIR/build/kernels`` and loaded in place of this checkout's libraries
for their turns, so the two checkouts' C signatures of those kernels must
be the same. The queues are those ``chip_smoke.py`` times the two kernels
on: K1 on the cornell main path's first 1080p chunk of primaries (524,288
rays, every lane closest), K2 on terrain200's 2,097,152 1080p primaries
(unsorted, broad-phase groups of 128), K3 on terrain200's bounce-1 queue
(the primaries' K1 hit points with scattered directions from a fixed
seed, coherence-sorted, closest). The turns go (this, other, other,
this) ``--rounds`` times; a turn is the mean of ``--iters`` raw launches
(``traverse_resident.bind`` / ``traverse_flat.bind``: operands and outputs
built beforehand) timed with CUDA events after a warm-up launch. Both
builds' outputs must be equal bitwise on each queue. Prints the card's name
and power limit, each turn, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.kernels import build
from realtimepathtracingresearchframework_tpu_torch.ops import integrator
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops import (
    traverse_resident as tr,
)
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3
from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
    frame_setup,
)

SIZE = (1920, 1080)
KERNELS = ("traverse_resident", tf.K2, tf.K3)


def build_other(root: Path) -> dict:
    """name -> ctypes.CDLL of ``root``'s build of each of KERNELS."""
    src = root / "realtimepathtracingresearchframework_tpu_torch" / "csrc"
    out_dir = root / "build" / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name in KERNELS:
        out = out_dir / f"lib{name}-other.so"
        procs[name] = (out, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out), str(src / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {root}'s {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def camera_queue(r, cfg, px, py, valid, block: int):
    """The packed (8, n) primaries of the pixels (px, py) of ``r``'s frame,
    dead where not ``valid``."""
    view = r._view(cfg.camera)
    state = pointsets.make_state(0, 0, 0, px, py, r.fb_width)
    _, ro, rd = integrator.camera_setup(
        integrator.IntegratorConfig(), view, px, py,
        (float(r.fb_width), float(r.fb_height)), state)
    return tr.pack_rays(ro, rd, 0.0, torch.where(valid, T_MAX, 0.0), block)[0]


def queues():
    """name -> bind() of KERNELS' queues: (run, the closest outputs (t,
    row, u, v))."""
    r, cfg = frame_setup("cornell", "cuda", SIZE)
    px, py, valid = (x[0] for x in r._swizzle)
    bvh = r.device_scene.bvh
    k1 = camera_queue(r, cfg, px, py, valid, 1).contiguous()
    n1 = -(-k1.shape[1] // tr.BLOCK)
    r2, cfg2 = frame_setup("terrain", "cuda", SIZE)
    fb = r2.device_scene.bvh
    k2 = camera_queue(r2, cfg2, *(torch.cat(x) for x in r2._swizzle), 512)
    k2 = k2.contiguous()
    n2 = k2.shape[1]
    k3 = bounce_queue(fb, k2).contiguous()
    n3 = k3.shape[1]
    return {
        "traverse_resident": lambda: tr.bind(bvh, tuple(k1[0:6]), k1[6], k1[7],
                                             n1)[0:2],
        tf.K2: lambda: tf.bind(tf.K2, fb, k2, 128, n2, n2 // 128)[0:2],
        tf.K3: lambda: tf.bind(tf.K3, fb, k3, 128, n3, 0)[0:2],
    }


def bounce_queue(fb, prim):
    """The packed bounce-1 queue of the primaries ``prim`` (as
    chip_smoke.py's phase 7 builds it): their K1 hit points, directions
    drawn from a fixed seed, dead where the primary missed,
    coherence-sorted."""
    h = tr.closest_hit_resident(fb, Vec3(*prim[0:3]), Vec3(*prim[3:6]),
                                prim[6], prim[7])
    hit = h.tri >= 0
    t = torch.where(hit, h.t, 0.0)
    p = [prim[k] + prim[3 + k] * t for k in range(3)]
    d = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, prim.shape[1])).astype(np.float32)).to(prim.device)
    d = d / torch.sqrt((d * d).sum(0))
    tmin = (torch.sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) + t
            ) * integrator.RAY_EPSILON
    q, _ = tr.pack_rays(Vec3(*p), Vec3(*d), tmin, torch.where(hit, T_MAX, 0.0),
                        1024)
    return tr._compact(q, fb.scene_lo, fb.scene_hi)[0]


def turn(bind, iters: int):
    """(ms per launch, outputs) of ``iters`` raw launches after a warm-up
    launch, timed with CUDA events."""
    run, outs = bind()

    def launch():
        rc = run()
        if rc != 0:
            raise RuntimeError(f"raw launch failed (cudaError {rc})")

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, outs


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    this = {name: build.load(name) for name in KERNELS}
    other = build_other(args.other.resolve())
    binds = queues()
    times = {name: {"this": [], "other": []} for name in KERNELS}
    for name in KERNELS:
        outs = {}
        for side in ("this", "other", "other", "this") * args.rounds:
            build._loaded[name] = this[name] if side == "this" else other[name]
            ms, out = turn(binds[name], args.iters)
            times[name][side].append(ms)
            outs.setdefault(side, out)
            print(f"{name} {side}: {ms:.4f} ms", flush=True)
        build._loaded[name] = this[name]
        same = all(torch.equal(_bits(x), _bits(y))
                   for x, y in zip(outs["this"], outs["other"]))
        print(f"{name}: this {[round(x, 4) for x in times[name]['this']]} ms, "
              f"other {[round(x, 4) for x in times[name]['other']]} ms; "
              f"outputs bitwise equal {same}", flush=True)
        if not same:
            raise RuntimeError(f"{name}: the two builds' outputs differ")
    print(json.dumps({name: {side: {"ms": ms, "median": float(np.median(ms))}
                             for side, ms in t.items()}
                      for name, t in times.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
