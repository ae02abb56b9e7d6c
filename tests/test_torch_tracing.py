"""The port's frame-path tracer on the CPU (``utils/profiling.py``): the
``rptr.`` stage spans and the counted blocking reads (``host_syncs``).

Two routes, each one frame under ``torch.profiler`` (CPU activity):
- ``executor``: ``procedural.village(grid=24)`` at 32x32, depth 3, textured,
  on the flat-cull route (``RPTR_TRAVERSAL_V3=1``) through the wavefront
  executor (``RPTR_HOST_WAVEFRONT=1``);
- ``monolith``: ``procedural.terrain(grid=16)`` at 32x32, depth 5, on the
  streamed route (``RPTR_FORCE_STREAMED_TRAVERSAL=1``) through the
  monolithic pass, in two chunks of 512 lanes.

Checked: every stage span of the route is emitted; ``rptr.shadow`` lies in
``rptr.nee``; the bounce stages lie in an ``rptr.bounce.<b>`` inside an
``rptr.pass``, camera and blend in the pass, the renderer's own reads
outside it; each site's ``host_syncs``
count equals its ``rptr.sync.<site>`` spans, and on the monolith the
``live`` reads are the bounces entered plus the early exits; without a
profiler a frame enters no ``record_function``, and its accumulation is
bitwise the profiled frame's.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.utils import profiling

torch.set_num_threads(1)  # see tests/test_torch_render.py

SIZE = 32
ROUTES = {
    # name: (environment, scene, depth, rays per pass, camera, sun)
    "executor": ({"RPTR_TRAVERSAL_V3": "1", "RPTR_HOST_WAVEFRONT": "1"},
                 lambda: procedural.village(grid=24), 3, None,
                 ([0, 4.0, 13.0], [0, 0.5, 0]), (0.35, 0.8, 0.3)),
    "monolith": ({"RPTR_FORCE_STREAMED_TRAVERSAL": "1"},
                 lambda: procedural.terrain(grid=16), 5, SIZE * SIZE // 2,
                 ([0, 5.0, 12.0], [0, 0, 0]), (0.4, 0.7, 0.2)),
}
STAGES = {
    "executor": {"rptr.camera", "rptr.closest", "rptr.shade", "rptr.nee",
                 "rptr.shadow", "rptr.sort", "rptr.blend"},
    "monolith": {"rptr.camera", "rptr.closest", "rptr.shade", "rptr.nee",
                 "rptr.shadow", "rptr.blend"},
}
SYNC_SITES = {
    # slab_inf: on the CPU, the plain versions of K2 and K3 test slabs too
    "executor": {"executor_live", "view_upload", "slab_inf"},
    # the binned shadow dispatch's entry table, subtree rows and bin layout
    "monolith": {"live", "view_upload", "slab_inf", "subtree_rows",
                 "bin_fill"},
}
# the renderer's own reads, before and after the frame's passes
RENDER_SITES = {"view_upload", "frame_event"}
BOUNCE_STAGES = {"rptr.closest", "rptr.shade", "rptr.nee", "rptr.shadow",
                 "rptr.sort"}
ENV = ("RPTR_TRAVERSAL_V3", "RPTR_HOST_WAVEFRONT",
       "RPTR_FORCE_STREAMED_TRAVERSAL", "RPTR_STREAM_CLOSEST",
       "RPTR_COMPACT_LANES", "RPTR_COMPACT", "RPTR_KERNEL_V4",
       "RPTR_TRAVERSAL_V1")


def _frame(route, monkeypatch, profiled: bool):
    """One frame of ``route`` on a fresh renderer: (accumulation, the
    profiler's events or None, host_syncs of the frame)."""
    env, scene, depth, rays_per_pass, (eye, center), sun = ROUTES[route]
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    r = (Renderer(device="cpu") if rays_per_pass is None
         else Renderer(device="cpu", rays_per_pass=rays_per_pass))
    sc = SceneConfig(sun_dir=sun, turbidity=3.0)
    r.initialize(SIZE, SIZE)
    r.set_scene(Scene.from_vkr_scene(scene()), scene_config=sc)
    cfg = FrameConfig(camera=OrientedCamera.look_at(eye, center, fovy=55),
                      params=RenderParams(batch_spp=1, max_path_depth=depth),
                      scene_config=sc)
    profiling.reset_host_syncs()
    events = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r.render(cfg)
        events = [e for e in prof.events() if e.name.startswith("rptr.")]
    else:
        r.render(cfg)
    if route == "executor":
        assert r._wavefront is not None and r._has_textures
    else:
        assert r._route.streamed and r._wavefront is None
        assert len(r._swizzle[0]) == 2
    return r.readback_accumulation(), events, dict(profiling.host_syncs)


@pytest.fixture(scope="module")
def traced():
    """Each route's profiled frame."""
    mp = pytest.MonkeyPatch()
    try:
        return {route: _frame(route, mp, profiled=True) for route in ROUTES}
    finally:
        mp.undo()


def _ancestors(e):
    out = []
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("rptr."):
            out.append(p.name)
        p = p.cpu_parent
    return out


def _is_bounce(name):
    return name.startswith("rptr.bounce.")


@pytest.mark.parametrize("route", list(ROUTES))
def test_stage_spans_nest(traced, route):
    _, events, _ = traced[route]
    names = {e.name for e in events}
    stages = {n for n in names
              if not (_is_bounce(n) or n.startswith(profiling.SYNC_PREFIX)
                      or n == "rptr.pass")}
    assert stages == STAGES[route]
    depth = ROUTES[route][2]
    assert {n for n in names if _is_bounce(n)} <= {
        f"rptr.bounce.{b}" for b in range(depth)}
    assert "rptr.bounce.0" in names
    for e in events:
        up = _ancestors(e)
        if e.name == "rptr.pass" or (
                e.name[len(profiling.SYNC_PREFIX):] in RENDER_SITES):
            assert not up, (e.name, up)
            continue
        assert up and up[-1] == "rptr.pass", (e.name, up)
        if e.name == "rptr.shadow":
            assert "rptr.nee" in up, up
        if e.name in BOUNCE_STAGES:
            assert any(_is_bounce(a) for a in up), (e.name, up)
        if _is_bounce(e.name) or e.name in ("rptr.camera", "rptr.blend"):
            assert up == ["rptr.pass"], (e.name, up)
    passes = sum(e.name == "rptr.pass" for e in events)
    assert passes == (1 if route == "executor" else 2)


@pytest.mark.parametrize("route", list(ROUTES))
def test_host_syncs_match_sync_spans(traced, route):
    _, events, syncs = traced[route]
    spans = collections.Counter(
        e.name[len(profiling.SYNC_PREFIX):] for e in events
        if e.name.startswith(profiling.SYNC_PREFIX))
    assert dict(spans) == syncs
    assert set(syncs) == SYNC_SITES[route]
    if route == "monolith":
        # each pass: one read before every bounce it enters, and one more
        # where it exits early (no live lane left before the last bounce)
        depth = ROUTES[route][2]
        want = 0
        for p in (e for e in events if e.name == "rptr.pass"):
            entered = sum(_is_bounce(c.name) for c in p.cpu_children)
            want += entered + (entered < depth)
        assert syncs["live"] == want
    else:
        # one live count after each bounce the executor ran
        assert syncs["executor_live"] == sum(_is_bounce(e.name) for e in events)


@pytest.mark.parametrize("route", list(ROUTES))
def test_no_profiler_no_spans_same_frame(traced, route, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    img, events, syncs = _frame(route, monkeypatch, profiled=False)
    assert events is None and syncs == traced[route][2]
    np.testing.assert_array_equal(img, traced[route][0])
    assert img[..., 3].mean() > 0.3
