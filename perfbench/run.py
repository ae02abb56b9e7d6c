"""The benchmark of the port (``realtimepathtracingresearchframework_tpu_torch``)
on one CUDA card: one cell of ``BENCHMARK.json`` per run.

    python3 -m perfbench.run --workload village-1080p --seed 7 --seconds 40 --trace 0

Set-up builds the cell's input scene, hands it to ``Renderer.set_scene``,
builds and loads the route's kernels and renders the warm frames. The
window then renders frames back to back for ``--seconds`` and ends with
``torch.cuda.synchronize()``: ``frame_ms`` is its wall time over the frames
it completed, ``setup_s`` the time from process start to its first frame.
``--trace 1`` renders the traced frames after the window and reports the
per-layer metrics instead. Then the accumulation is judged against the
reference (``check.py``). Diagnostics go to standard error, the compared
numbers with their limits last; the result is the last line of standard
output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from perfbench import check, noise
from perfbench.cells import ROOT, Cell, load_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "realtimepathtracingresearchframework_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


def log(*a):
    print("perfbench:", *a, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             start_s: float = 0.0) -> dict:
    """One run of ``cell``; ``start_s`` is the set-up already spent before
    the call. Returns the result line's object."""
    import torch

    from perfbench import program as prog_mod
    from perfbench import scenes
    from perfbench.reference.render import Reference
    from perfbench.trace import breakdown, busy_us, profile_frames

    cuda = device != "cpu"
    t_setup = time.perf_counter()
    traffic, config = cell.traffic, cell.config
    width, height = int(traffic["width"]), int(traffic["height"])
    t0 = time.perf_counter()
    vs = scenes.build(config)
    log(f"set-up: scene_build {time.perf_counter() - t0!r} s")
    prog = prog_mod.Program(config, traffic, vs, device=device, log=log)
    prog.load_kernels()
    prog.warm(int(traffic["warm_frames"]))
    prog.set_shot(seed)
    for k, v in prog.phases.items():
        log(f"set-up: {k} {v!r} s")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    setup_s = start_s + time.perf_counter() - t_setup
    log(f"set-up: setup_s {setup_s!r} s")
    host0 = noise.host_state()
    smi = noise.SmiSampler() if cuda else None
    frame_s = []
    frames = 0
    w0 = time.perf_counter()
    t_end = w0 + seconds
    while True:
        ta = time.perf_counter()
        prog.render()
        frames += 1
        tb = time.perf_counter()
        frame_s.append(tb - ta)
        if tb >= t_end:
            break
    sync()
    wall_s = time.perf_counter() - w0
    smi_rows = smi.stop() if smi else []
    host1 = noise.host_state()
    q = noise.quartiles([1e3 * s for s in frame_s])
    blocks = [round(1e3 * sum(frame_s[i:i + 10]) / len(frame_s[i:i + 10]), 1)
              for i in range(0, frames, 10)]
    log(f"window: {frames} frames in {wall_s!r} s; per-call ms quartiles {q}; "
        f"per-call ms means by 10 frames {blocks}")
    log(f"host: start {host0}, end {host1}")
    log(f"nvidia-smi (sm MHz, W, limit W, C) beside the window: {smi_rows}")

    tr = None
    rays_total = None
    profiled = int(traffic["profiled_frames"]) if trace else 0
    if trace:
        tr = profile_frames(prog.render, profiled, sync, log=log)
        rays_total = prog.rays_last_frame()
    sync()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = prog.spans()
    px, py = check.sample_pixels(seed, width, height, int(traffic["check_pixels"]))
    got = prog.display(px, py)
    accumulated = prog.frames_accumulated()
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = Reference(vs, config["camera"], config["sun"], width, height,
                    int(traffic["max_depth"]), traffic["light_selection"],
                    device)
    want = ref.pixels(px, py, frames + profiled, seed)
    log(f"reference: {len(px)} pixels x {frames + profiled} frames in "
        f"{time.perf_counter() - t0!r} s ({ref.scene.walk.steps} walk steps); "
        f"the program accumulated {accumulated} frames")
    limits = check.limits_for(config)
    numbers = check.compare(got, want)
    correct = check.judge(numbers, limits)

    if trace:
        rays = None
        if rays_total and ref.closest_rays + ref.shadow_rays:
            share = ref.closest_rays / (ref.closest_rays + ref.shadow_rays)
            rays = {"closest": rays_total * share,
                    "any_hit": rays_total * (1.0 - share)}
        # what a reader may read: the trace, the program's spans and
        # counters, the cell's files, and the rays a frame by kind (the
        # program's total split as the reference's rays are: an estimate)
        ctx = {"trace": tr, "rays_per_frame": rays, "spans": spans,
               "config": config, "traffic": traffic}
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        metrics = {}
        for name, read in cell.readers.items():
            value = read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
    else:
        values = {"frame_ms": 1e3 * wall_s / frames, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": frames + profiled,
              "failed": 0 if correct else frames + profiled,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = busy_us(tr) * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        result["breakdown"] = breakdown(tr)
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    age0, t_age = process_age(), time.perf_counter()
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    cell = load_cell(args.workload)
    t0 = time.perf_counter()
    import torch

    log(f"set-up: import_torch {time.perf_counter() - t0!r} s")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s): is_available "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    log(f"set-up: cuda_init {time.perf_counter() - t0!r} s, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    import perfbench.program  # noqa: F401  (the port's modules)

    log(f"set-up: import_program {time.perf_counter() - t0!r} s")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      start_s=age0 + time.perf_counter() - t_age)
    bad = forbidden_modules()
    if bad:
        log(f"modules that the benchmark may not load are loaded: {bad}")
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for line in check.lines(result["check"]):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
