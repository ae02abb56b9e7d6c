"""CPU + device profiling scopes.

TPU-native equivalent of:
- RAII ``ProfilingScope`` with static per-site records and hierarchical dump
  (``util/profiling.h:8-68``).
- GPU timestamp markers (``vulkan/profiling/profiling_scopes.h:20-198``):
  the marker taxonomy is kept. The PyTorch port's copy of the reference
  module: ``DeviceTimers.interval`` brackets device work with a pair of
  CUDA events on a card (a timestamp pair at queue granularity, read once
  the work has completed, so the frame loop never waits for it) and with
  the host clock on the CPU; ``time`` brackets with a device synchronize.
- The frame path's tracer (no reference counterpart): ``span`` names a
  stage of the frame as a ``torch.profiler.record_function`` range while
  a profiler records, and ``host_read`` / ``host_sync`` count and span each
  blocking device-to-host read (``host_syncs``); ``count_shaded`` counts
  the shaded bounces by path (``shaded_bounces``).
"""

from __future__ import annotations

import collections
import contextlib
import enum
import time
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from realtimepathtracingresearchframework_tpu_torch.utils.online_stats import OnlineStats


class ProfilingMarker(enum.Enum):
    """Per-frame device timing markers.

    Mirrors the taxonomy of ``vulkan/profiling/profiling_scopes.h:20-125``.
    """

    BUILD_BLAS = "BuildBLAS"
    UPDATE_BLAS = "UpdateBLAS"
    BUILD_TLAS = "BuildTLAS"
    UPDATE_TLAS = "UpdateTLAS"
    RENDERING = "Rendering"
    PROCESSING = "Processing"
    TAA = "TAA"
    DOF = "DoF"
    RESTIR = "ReStir"
    DENOISE = "Denoise"
    READBACK = "Readback"


@dataclass
class _ScopeRecord:
    name: str
    level: int
    total_s: float = 0.0
    count: int = 0


class _ProfilerState(threading.local):
    def __init__(self):
        self.level = 0
        self.records: Dict[str, _ScopeRecord] = {}
        self.order: List[str] = []


_state = _ProfilerState()


class ProfilingScope:
    """Hierarchical CPU profiling scope (util/profiling.h:62).

    Usable as a context manager::

        with ProfilingScope("load scene"):
            ...
    """

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        _state.level += 1
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _state.level -= 1
        rec = _state.records.get(self.name)
        if rec is None:
            rec = _ScopeRecord(self.name, _state.level)
            _state.records[self.name] = rec
            _state.order.append(self.name)
        rec.total_s += dt
        rec.count += 1
        return False


def log_profiling_times(printer=print) -> None:
    """Dump the hierarchical scope log (util/profiling.cpp equivalent)."""
    for name in _state.order:
        rec = _state.records[name]
        printer(
            "%s%-40s %9.3f ms  (x%d)"
            % ("  " * rec.level, rec.name, rec.total_s * 1e3, rec.count)
        )


def reset_profiling() -> None:
    _state.records.clear()
    _state.order.clear()


class DeviceTimers:
    """Per-frame device marker timings with a sliding stats window.

    Equivalent of the GPU timestamp query pools + the 32-frame stabilized
    window of ``ProcessProfilingToolsVulkan``
    (vulkan/processing/process_profiling_tools.h:26-43).
    """

    WINDOW = 32

    def __init__(self):
        self._frame: Dict[str, float] = {}
        self._frame_events: List[tuple] = []  # (name, start, end) CUDA events
        # frames ended whose events have not all completed, oldest first
        self._pending = collections.deque()
        self._history: Dict[str, List[float]] = {}
        self.stats: Dict[str, OnlineStats] = {}

    @contextmanager
    def time(self, marker: ProfilingMarker, result_to_block=None):
        """Bracket a device dispatch; if ``result_to_block`` thunk is given it
        is called and its result blocked on before stopping the clock."""
        t0 = time.perf_counter()
        out = {}
        yield out
        val = out.get("result", result_to_block)
        if val is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.add(marker, dt_ms)

    def add(self, marker: ProfilingMarker, ms: float) -> None:
        name = marker.value
        self._frame[name] = self._frame.get(name, 0.0) + ms

    def add_events(self, marker: ProfilingMarker, start, end) -> None:
        """Add the device interval between two recorded CUDA events to this
        frame; it is read once ``end`` has completed."""
        self._frame_events.append((marker.value, start, end))

    @contextmanager
    def interval(self, marker: ProfilingMarker, device):
        """Time the work queued inside the block: by CUDA events on a CUDA
        ``device`` (no synchronisation), else by the host clock."""
        if getattr(device, "type", device) == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.add_events(marker, start, end)
        else:
            t0 = time.perf_counter()
            yield
            self.add(marker, (time.perf_counter() - t0) * 1e3)

    def end_frame(self) -> Dict[str, float]:
        """End the frame: its timings go into the sliding window once its
        device intervals have completed (frames in order). Returns its host
        timings."""
        frame = dict(self._frame)
        self._pending.append((dict(frame), self._frame_events))
        self._frame.clear()
        self._frame_events = []
        self.poll()
        return frame

    def poll(self, wait: bool = False) -> None:
        """Roll every ended frame whose device intervals have completed into
        the window, oldest first; ``wait`` waits for them all."""
        while self._pending:
            frame, events = self._pending[0]
            if not wait and not all(e.query() for _, _, e in events):
                return
            for name, start, end in events:
                end.synchronize()
                frame[name] = frame.get(name, 0.0) + start.elapsed_time(end)
            self._pending.popleft()
            for name, ms in frame.items():
                hist = self._history.setdefault(name, [])
                hist.append(ms)
                if len(hist) > self.WINDOW:
                    hist.pop(0)
                st = self.stats.setdefault(name, OnlineStats())
                st.add(ms)

    def window_stats(self, marker: ProfilingMarker):
        """(avg, mn, mx, stddev) over the sliding window for a marker, after
        waiting for the frames still in flight."""
        self.poll(wait=True)
        hist = self._history.get(marker.value)
        if not hist:
            return (0.0, 0.0, 0.0, 0.0)
        st = OnlineStats()
        for v in hist:
            st.add(v)
        return (st.mean, st.minimum, st.maximum, st.stddev)


# ---------------------------------------------------------------------------
# Stage spans and counted host syncs of the frame path
# ---------------------------------------------------------------------------

# a profiler's trace holds the spans as ``user_annotation`` ranges on the
# clock of its CUDA activities, so a kernel belongs to the innermost stage
# open at its launch and an idle gap of the device to the span the host was
# in. Spans, outermost first: rptr.pass (a monolithic chunk pass or the
# executor's whole-frame sample) > rptr.bounce.<b> > the stages rptr.closest,
# rptr.shade, rptr.nee (> rptr.shadow) and rptr.sort; rptr.camera and
# rptr.blend lie in the pass, outside its bounces; rptr.sync.<site> around
# each blocking read, inside whatever stage makes it
SYNC_PREFIX = "rptr.sync."
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled

# blocking device-to-host reads by site since the last reset_host_syncs()
host_syncs: Dict[str, int] = collections.Counter()

# shaded bounces by path since the last reset_shaded(): "fused" (the
# rptr.shade stage's two kernels, ops/shade.py; their plain versions on CPU
# tensors) or "plain" (the configurations the kernels do not implement)
shaded_bounces: Dict[str, int] = collections.Counter()


def span(name: str, part=None):
    """``torch.profiler.record_function(name)`` while a profiler records
    (``name.<part>`` with a ``part``), else a shared no-op context: one
    check, and nothing allocated, launched or read."""
    if not _profiler_enabled():
        return _NO_SPAN
    if part is not None:
        name = f"{name}.{part}"
    return torch.profiler.record_function(name)


def host_sync(site: str):
    """Count one blocking read at ``site`` and return its span
    (``rptr.sync.<site>``), for a read that an operation makes implicitly
    (a boolean mask's index, a host-to-device copy that waits)."""
    host_syncs[site] += 1
    return span("rptr.sync", site)


def host_read(site: str, value):
    """The frame path's blocking read of ``value`` at ``site``, counted and
    spanned by ``host_sync``: a one-element tensor's Python value, or, for
    a CUDA event, the wait for its completion (returns None)."""
    with host_sync(site):
        if isinstance(value, torch.Tensor):
            return value.item()
        value.synchronize()
        return None


def reset_host_syncs() -> None:
    host_syncs.clear()


def count_shaded(fused: bool) -> None:
    """Count one shaded bounce on the path ``ops/shade.fused`` chose."""
    shaded_bounces["fused" if fused else "plain"] += 1


def reset_shaded() -> None:
    shaded_bounces.clear()


def fused_shade_share() -> float:
    """Percent of the shaded bounces since the last ``reset_shaded`` that
    took the fused path (0 when none was shaded)."""
    total = shaded_bounces["fused"] + shaded_bounces["plain"]
    return 100.0 * shaded_bounces["fused"] / total if total else 0.0
