"""The stage and sync readers' arithmetic on a hand-written profiler trace
(``data/trace_stages.json``): a 10 ms window of two frames, the port's
``rptr.`` spans, eleven launch calls and their kernels in it, one of each
after it.

Frame one: camera 100 us; a closest stage with a sort kernel (50 us, glue)
and a K4 walk (400 us); shade 200 us; NEE 300 us of its own, its shadow
stage a pad gather (70 us, glue) and a K5 walk (150 us), an ``alpha_cut``
read (300 us) inside; a sort stage (80 us, glue); blend 60 us; a kernel
launched in the pass outside any stage (40 us); a ``live`` read (100 us).
Frame two: shade 100 us, a ``frame_event`` read (200 us). Every launch
but the walks' lies in an operator (``aten::op``)."""

import json

import pytest

from perfbench.cells import metric_reader
from perfbench.stages import kernel_stages
from perfbench.tests.helpers import DATA
from perfbench.trace import summarize

NEW = ["host_syncs_per_frame", "sync_wait_ms", "shade_device_ms",
       "nee_device_ms", "glue_device_ms"]
DEVICE = ["shade_device_ms", "nee_device_ms", "glue_device_ms"]


def _events(name="trace_stages.json"):
    with open(DATA / name) as f:
        return json.load(f)["traceEvents"]


@pytest.fixture(scope="module")
def ctx():
    return {"trace": summarize(_events(), frames=2)}


@pytest.mark.parametrize("name, value", [
    ("host_syncs_per_frame", 1.5),
    ("sync_wait_ms", (100 + 300 + 200) / 2 / 1e3),
    ("shade_device_ms", (200 + 100) / 2 / 1e3),
    ("nee_device_ms", 300 / 2 / 1e3),
    ("glue_device_ms", (50 + 70 + 80) / 2 / 1e3),
])
def test_stage_reader(ctx, name, value):
    assert metric_reader(name)(ctx) == pytest.approx(value, rel=1e-12)


def test_kernels_go_to_the_innermost_stage(ctx):
    ks = kernel_stages(ctx["trace"])
    assert [st for st, _, _ in ks] == [
        "rptr.camera", "rptr.closest", "rptr.closest", "rptr.shade",
        "rptr.nee", "rptr.shadow", "rptr.shadow", "rptr.sort", "rptr.blend",
        None, "rptr.shade"]
    assert sum(d for _, _, d in ks) == 1550


@pytest.mark.parametrize("name", NEW)
def test_stage_reader_without_a_trace_reads_nothing(name):
    assert metric_reader(name)({"trace": None}) is None


@pytest.mark.parametrize("name", NEW)
def test_stage_reader_without_the_ports_spans_reads_nothing(name):
    """A program without the spans (an older commit): nothing to read."""
    tr = summarize(_events("trace_small.json"), frames=2)
    assert metric_reader(name)({"trace": tr}) is None


def _moved(ev, moves):
    """The events with the kernels that start at a key of ``moves`` moved
    to its value."""
    return [dict(e, ts=moves[e["ts"]])
            if e["cat"] == "kernel" and e["ts"] in moves else e for e in ev]


@pytest.mark.parametrize("name, value", [
    ("shade_device_ms", 200 / 2 / 1e3),
    ("nee_device_ms", 300 / 2 / 1e3),
    ("glue_device_ms", (50 + 70 + 80) / 2 / 1e3),
])
def test_kernels_outside_the_window_at_its_edges(name, value):
    """The profiler puts the first launch's kernel (camera) before the
    window and the last one's (frame two's shade) after it, its device
    clock drifting from the host's: the walks place the rest, which are
    read as launched."""
    ev = _moved(_events(), {1200: 900, 6310: 11500})
    tr = summarize(ev, frames=2)
    assert len(tr.kernels) == 9 and tr.launches == 11
    ks = kernel_stages(tr)
    assert [st for st, _, _ in ks] == [
        "rptr.closest", "rptr.closest", "rptr.shade", "rptr.nee",
        "rptr.shadow", "rptr.shadow", "rptr.sort", "rptr.blend", None]
    assert metric_reader(name)({"trace": tr}) == pytest.approx(value,
                                                               rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_unpaired_launches_read_nothing(name):
    """A kernel missing inside the window: the walks meet the launches at
    no offset, so the device readers give None; the sync readers, which
    need no pairing, still read."""
    ev = _events()
    drop = next(i for i, e in enumerate(ev)
                if e["cat"] == "kernel" and "(nee)" in e["name"])
    tr = summarize(ev[:drop] + ev[drop + 1:], frames=2)
    value = metric_reader(name)({"trace": tr})
    assert (value is None) == (name in DEVICE)
