"""The traced frames: ``torch.profiler`` over a few frames, reduced to what
the per-layer metrics read.

The profiler's trace is written to a file under ``TMPDIR``, read back and
deleted. ``summarize`` turns its events into a ``Trace``: the device
activities (kernels, copies, sets) and the host's launch calls inside the
traced window, which the harness marks with a ``perfbench.profiled`` span
around the frames and their final synchronise.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_SPAN = "perfbench.profiled"
FRAME_SPAN = "perfbench.render"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
NAME_CHARS = 96  # a kernel's name as the breakdown gives it
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


@dataclass
class Trace:
    frames: int
    window_us: float
    kernels: List[Tuple[str, float, float]]  # (name, start us, duration us)
    device: List[Tuple[str, float, float]]  # kernels, copies and sets
    launch_us: float  # host time in the launch calls
    launches: int
    host: List[Tuple[str, float, float]] = field(default_factory=list)


def union_us(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total if cur_e is None else total + cur_e - cur_s


def summarize(events: List[dict], frames: int) -> Trace:
    """A ``Trace`` from chrome-trace events (``traceEvents``)."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW_SPAN} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])

    def inside(e):
        return e.get("ph") == "X" and w0 <= float(e["ts"]) < w1

    device, kernels, host = [], [], []
    launch_us, launches = 0.0, 0
    for e in events:
        if not inside(e):
            continue
        cat = e.get("cat")
        item = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(item)
            if cat == "kernel":
                kernels.append(item)
        elif cat in HOST_CATS:
            if item[0] != WINDOW_SPAN:
                host.append(item)
            if cat in ("cuda_runtime", "cuda_driver") and item[0] in LAUNCH_CALLS:
                launch_us += item[2]
                launches += 1
    return Trace(frames=frames, window_us=w1 - w0, kernels=kernels,
                 device=device, launch_us=launch_us, launches=launches,
                 host=host)


def busy_us(trace: Trace) -> float:
    """The time in which some device activity ran: the window ends with a
    synchronise, so every activity that starts in it ends in it."""
    return union_us((s, s + d) for _, s, d in trace.device)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps of the device by the innermost host span open at their middle."""
    by_name: Dict[str, float] = {}
    for name, _, dur in trace.device:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted(trace.host, key=lambda h: h[1])
    starts = [s for _, s, _ in spans]
    frames = [(s, s + d) for n, s, d in spans if n == FRAME_SPAN]
    frame_starts = [s for s, _ in frames]
    busy = sorted((s, s + d) for _, s, d in trace.device)
    gaps: Dict[str, float] = {}
    end = None
    for s, e in busy:
        if end is not None and s > end:
            mid = 0.5 * (end + s)
            name = "idle"
            f = bisect.bisect_right(frame_starts, mid) - 1
            if f >= 0 and frames[f][1] >= mid:
                name = FRAME_SPAN
            # the latest-started span still open is the innermost; spans
            # that opened long before are the frame's own
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 400, -1), -1):
                hn, hs, hd = spans[j]
                if hs + hd >= mid:
                    name = hn
                    break
            gaps[name] = gaps.get(name, 0.0) + (s - end)
        end = e if end is None else max(end, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], t * 1e-6] for n, t in ops],
            "idle_gaps": [[n, t * 1e-6] for n, t in idle]}


def profile_frames(render, frames: int, sync, log=print) -> Trace:
    """Profile ``frames`` calls of ``render`` and a final ``sync``; the
    trace file lives under ``TMPDIR`` only while it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(frames):
                with record_function(FRAME_SPAN):
                    render()
            sync()
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    log(f"trace: {len(events)} events, {size} bytes, deleted")
    return summarize(events, frames)
