"""The per-layer metric arithmetic on a recorded profiler trace
(``data/trace_small.json``: a 10 ms window of two frames, four device
activities in it, one after it)."""

import json

import pytest

from perfbench.cells import metric_reader
from perfbench.tests.helpers import DATA
from perfbench.trace import breakdown, busy_us, summarize, union_us


@pytest.fixture(scope="module")
def ctx():
    with open(DATA / "trace_small.json") as f:
        tr = summarize(json.load(f)["traceEvents"], frames=2)
    return {"trace": tr, "rays_per_frame": {"closest": 1e6, "any_hit": 5e5},
            "spans": {"phase.warm_frames": 1.25, "setup_seconds": 0.5}}


@pytest.mark.parametrize("name, value", [
    ("kernels_per_frame", 1.5),
    ("host_launch_ms", 0.03),
    ("walk_ms", 0.75),
    ("eager_device_ms", 0.75),
    ("device_idle_share", 75.0),
    ("walk_roofline", 100.0 * (48e6 + 33 * 5e5) / 3.35e12 / 0.75e-3),
    ("scene_setup_s", 0.5),
    ("warmup_s", 1.25),
])
def test_reader(ctx, name, value):
    assert metric_reader(name)(ctx) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("name", ["kernels_per_frame", "host_launch_ms", "walk_ms",
                                  "eager_device_ms", "device_idle_share",
                                  "walk_roofline"])
def test_reader_without_a_trace_reads_nothing(name):
    assert metric_reader(name)({"trace": None, "rays_per_frame": None}) is None


def test_window_and_busy(ctx):
    tr = ctx["trace"]
    assert tr.window_us == 10000 and tr.launches == 3
    assert busy_us(tr) == 2500
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_breakdown(ctx):
    b = breakdown(ctx["trace"])
    ops = dict(b["device_ops"])
    assert len(ops) == 4 and sum(ops.values()) == pytest.approx(3e-3)
    assert [t for _, t in b["device_ops"]][:2] == pytest.approx([1e-3, 1e-3])
    assert dict((n, t) for n, t in b["idle_gaps"]) == pytest.approx(
        {"aten::add": 1.5e-3, "perfbench.render": 1.5e-3})
