"""Benchmark aggregation + CSV writer.

Equivalent of ``BenchmarkInfo`` (libapp/benchmark_info.{h,cpp}): per-frame
render/app time aggregation with Welford + EMA stats, and a CSV with the
reference schema ``frames_total, keyframe, frames_accumulated,
render_time_ms, app_time_ms[, extension columns]``
(benchmark_info.cpp:74-87,101-124). Extensions contribute extra columns via
the BenchmarkCSVSource protocol (benchmark_info.h:29-36).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Protocol, Sequence

from realtimepathtracingresearchframework_tpu_torch.utils.online_stats import OnlineStats


class BenchmarkCSVSource(Protocol):
    """Extension hook contributing extra CSV columns."""

    def csv_header(self) -> List[str]: ...

    def csv_values(self) -> List[float]: ...


@dataclass
class BenchmarkInfo:
    render_time_stats: OnlineStats = field(default_factory=OnlineStats)
    app_time_stats: OnlineStats = field(default_factory=OnlineStats)
    frames_total: int = 0
    _csv_file = None
    _sources: List[BenchmarkCSVSource] = field(default_factory=list)
    _render_times: List[float] = field(default_factory=list)

    def register_source(self, source: BenchmarkCSVSource) -> None:
        self._sources.append(source)

    def aggregate_frame(self, render_time_ms: float, app_time_ms: float) -> None:
        self.frames_total += 1
        self.render_time_stats.add(render_time_ms)
        self.app_time_stats.add(app_time_ms)
        self._render_times.append(render_time_ms)

    def open_csv(self, path: str) -> None:
        self._csv_file = open(path, "w")
        cols = [
            "frames_total",
            "keyframe",
            "frames_accumulated",
            "render_time_ms",
            "app_time_ms",
        ]
        for s in self._sources:
            cols.extend(s.csv_header())
        self._csv_file.write(", ".join(cols) + "\n")

    def write_csv(
        self,
        keyframe: int,
        frames_accumulated: int,
        render_time_ms: float,
        app_time_ms: float,
    ) -> None:
        if self._csv_file is None:
            return
        vals = [
            str(self.frames_total),
            str(keyframe),
            str(frames_accumulated),
            f"{render_time_ms:.4f}",
            f"{app_time_ms:.4f}",
        ]
        for s in self._sources:
            vals.extend(f"{v:.4f}" for v in s.csv_values())
        self._csv_file.write(", ".join(vals) + "\n")

    def close_csv(self) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = None

    def p50_render_time(self) -> float:
        if not self._render_times:
            return 0.0
        xs = sorted(self._render_times)
        return xs[len(xs) // 2]
