"""Carry compaction of the port's monolithic bounce loop
(``IntegratorConfig.compact_lanes``; reference integrator.py:1606-1717) on
the CPU.

The cases of tests/test_compact_lanes.py on the port: ``trace_paths`` over
6,144 random lanes in the cornell box at depth 5 (two prefix sizes: 6,144
and 3,072 lanes), with and without the wavefront variant, and the
Renderer at 96x64 (one 6,144-lane chunk), depth 5, two frames, in both
variants, each with compaction on against off. The reference holds its
radiance to rtol 3e-5 / atol 1e-7 there, because XLA rounds differently by
program shape; the port runs the same elementwise tensor code on every
prefix and every kernel is a per-lane function, so here the frame is
bitwise the uncompacted one, and the tests say so.

Then a small flat-cull scene (``procedural.terrain(grid=24)`` forced onto
K2/K3 with ``RPTR_TRAVERSAL_V3=1`` and the monolith with
``RPTR_HOST_WAVEFRONT=0``, where compaction is on by default) at 64x32
(2,048 lanes: prefixes of 2,048 and 1,024), depth 5, two frames: bitwise
the port's uncompacted frame, and against the JAX renderer with its own
carry compaction forced on (``RPTR_COMPACT_LANES=1``): ray counts per
frame exact, radiance at ``goldens.compare_ref``'s gate.
"""

import os

import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    VARIANT_MEGAKERNEL,
    VARIANT_WAVEFRONT,
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import (
    OrientedCamera,
)
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_flat as tf
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3
from realtimepathtracingresearchframework_tpu_torch.profile_frame import frame_setup

torch.set_num_threads(1)  # see tests/test_torch_render.py

SCFG = SceneConfig(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)
ROUTE_ENV = ("RPTR_TRAVERSAL_V3", "RPTR_HOST_WAVEFRONT", "RPTR_COMPACT_LANES",
             "RPTR_COMPACT", "RPTR_KERNEL_V4", "RPTR_TRAVERSAL_V1",
             "RPTR_FORCE_STREAMED_TRAVERSAL", "RPTR_STREAM_CLOSEST")


class _env:
    """Set the route's environment for a block, restoring it after."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.pop(k, None) for k in ROUTE_ENV}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k in ROUTE_ENV:
            os.environ.pop(k, None)
            if self.old[k] is not None:
                os.environ[k] = self.old[k]


@pytest.fixture
def compacted(monkeypatch):
    """Counts the bounces that ran compacted (on a lane prefix)."""
    calls = []
    orig = ti._compacted_bounces

    def spy(ds, cfg, carry, sizes, *fns):
        calls.append(tuple(sizes))
        return orig(ds, cfg, carry, sizes, *fns)

    monkeypatch.setattr(ti, "_compacted_bounces", spy)
    return calls


@pytest.fixture(scope="module")
def cornell():
    r = Renderer(device="cpu")
    r.initialize(64, 64)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()), scene_config=SCFG)
    return r


@pytest.mark.parametrize("wavefront", [False, True])
def test_trace_paths_compact_lanes(cornell, compacted, wavefront):
    """Path structure (rays per lane, alpha) and radiance bitwise the
    uncompacted loop's."""
    ds = cornell.device_scene
    base = cornell._integrator_config(
        RenderParams(batch_spp=1, max_path_depth=5))._replace(
        compact=False, compact_lanes=False, wavefront=wavefront)
    n = 6144
    rng = np.random.default_rng(3)
    p = np.full((n, 3), (0.0, 1.0, 0.5), np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = Vec3(*(torch.from_numpy(p[:, k].copy()) for k in range(3)))
    rd = Vec3(*(torch.from_numpy(d[:, k].copy()) for k in range(3)))
    st = tps.RngState(torch.from_numpy(rng.integers(0, 1 << 31, n)),
                      torch.from_numpy(rng.integers(0, 1 << 31, n)))
    fp = ti.FrameParams(rr_path_depth=2)
    i0, a0, r0 = ti.trace_paths(ds, base, fp, ro, rd, st)
    assert not compacted
    i1, a1, r1 = ti.trace_paths(ds, base._replace(compact_lanes=True), fp, ro,
                                rd, st)
    assert compacted == [(6144, 3072)]
    assert torch.equal(r0, r1) and torch.equal(a0, a1)
    for x, y in zip(i0, i1):
        assert torch.equal(x, y)
    # some lanes died, so later bounces ran on the 3,072-lane prefix
    assert int((r0 > 0).sum()) == n and float(a0.mean()) > 0.5


def _render(variant, compact_lanes, compacted):
    with _env(RPTR_COMPACT_LANES="1" if compact_lanes else "0"):
        r = Renderer(device="cpu")
        r.initialize(96, 64)
        r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()),
                    scene_config=SCFG)
        r.set_variant(variant)
        cfg = FrameConfig(
            camera=OrientedCamera.look_at([0, 1.2, 3.0], [0, 0.8, 0.0], fovy=55),
            params=RenderParams(batch_spp=1, max_path_depth=5, rr_path_depth=2),
            scene_config=SCFG)
        before = len(compacted)
        for _ in range(2):
            r.render(cfg)
        assert (len(compacted) - before == 2) == compact_lanes
        return r.readback_framebuffer(), r.last_frame_rays()


@pytest.mark.parametrize("variant", [VARIANT_MEGAKERNEL, VARIANT_WAVEFRONT])
def test_renderer_compact_lanes(variant, compacted):
    base, base_rays = _render(variant, False, compacted)
    comp, comp_rays = _render(variant, True, compacted)
    assert base.shape == comp.shape == (64, 96, 4)
    assert comp_rays == base_rays
    np.testing.assert_array_equal(comp, base)


def _port_flat(compact_lanes, compacted):
    kv = {"RPTR_TRAVERSAL_V3": "1", "RPTR_HOST_WAVEFRONT": "0"}
    if not compact_lanes:
        kv["RPTR_COMPACT_LANES"] = "0"
    with _env(**kv):
        r, cfg = frame_setup("terrain", "cpu", (64, 32), 5, 24)
        assert isinstance(r.device_scene.bvh, tf.FlatBVH)
        assert r._integrator_config(cfg.params).compact_lanes == compact_lanes
        before, rays = len(compacted), []
        for _ in range(2):
            r.render(cfg)
            rays.append(r.last_frame_rays())
        assert r._wavefront is None
        assert (len(compacted) - before == 2) == compact_lanes
    return r.readback_accumulation(), rays, cfg


def test_flat_cull_compacted_matches_jax(compacted):
    img, rays, cfg = _port_flat(True, compacted)
    plain, plain_rays, _ = _port_flat(False, compacted)
    assert rays == plain_rays
    np.testing.assert_array_equal(img, plain)
    with _env(RPTR_HOST_WAVEFRONT="0", RPTR_COMPACT_LANES="1"):
        jr = jrend.Renderer()
        jr.initialize(64, 32)
        sc = cfg.scene_config
        jr.set_scene(JaxScene.from_vkr_scene(jproc.terrain(grid=24)),
                     scene_config=sc)
        jcfg = jrend.FrameConfig(camera=cfg.camera, params=cfg.params,
                                 scene_config=sc)
        assert jr._integrator_config(cfg.params).compact_lanes
        jrays = []
        for _ in range(2):
            jr.render(jcfg)
            jrays.append(sum(int(x) for x in jr._last_rays))
        jimg = np.asarray(jr.readback_accumulation())
    assert rays == jrays
    assert img[..., 3].mean() > 0.3
    res = goldens.compare_ref(img[..., :3], jimg[..., :3].astype(np.float64))
    assert res["ok"], res
