"""Multi-device rendering of the port on the CPU (the counterparts of
tests/test_parallel.py; reference ``parallel/``, ``Renderer(devices=...)``,
``__graft_entry__.py``).

- ``parallel.mesh``: ``make_mesh`` / ``make_mesh_2d`` and the reference's
  ``ValueError`` on too few devices; ``replicate`` onto the ``meta``
  device (a device other than the source's without a card): every tensor
  leaf moved, numpy arrays and ints (K7's static metadata) kept as the same
  objects, and a memo that copies only the leaves that changed.
- ``build_sharded_render`` over ``["cpu"] * 8`` (cornell 32x32, 2 spp,
  depth 3) and ``build_sharded_render_2d`` over a 2 x 4 grid (64x32, 1
  spp) against ``integrator.render_tile`` of the whole frame: bitwise,
  ray totals exact; the ``ValueError``s on a height or width that does not
  divide.
- Row bands (the 48x48 cornell_diffuse golden frame as three bands of 16
  rows, the golden's 4 spp) against the JAX package's ``camera_setup`` +
  ``trace_paths`` on the same offset pixels, run op by op under
  ``jax.disable_jit()`` on the same scene arrays (as
  tests/test_torch_render.py does): ray counts per lane exact, radiance of
  the frame they form at ``goldens.compare_ref``'s gate.
- ``Renderer(devices=["cpu"] * n)`` for n in (2, 4) against
  ``Renderer(device="cpu")`` with the same chunking (several swizzle
  chunks a frame, so the round-robin reaches every device), bitwise in
  ``readback_accumulation`` and ``readback_framebuffer``: cornell 64x64
  over 2 frames; a terrain on the flat-cull route against the single
  renderer with ``RPTR_HOST_WAVEFRONT=0`` (the executor is off on several
  devices, so both take the monolith); a streamed terrain; an animated
  instanced field on the K6 and on the K7 route over three
  ``set_animation_frame`` calls, each replica holding the frame's TLAS side
  and K7's static metadata still numpy and ints on every replica.
- The first device's paths on 3 devices against one: planar, image-domain
  (ACCUMULATE, upscale 2) and planar frames again, the ray queries, the
  AOVs and the ray-stats image, bitwise.
- ``save_state`` of a 4-device renderer loaded into a single one and a
  2-device one: ``frame_id`` and the image kept, and the next frame
  bitwise the 4-device renderer's.
- ``warmup_async`` runs its pass on every device; several cards time
  frames by the host clock over the ``sync_interval`` window.
- The CLI: ``--backend cpu --devices 2`` writes the same PNG as
  ``--devices 1``; ``parallel.dryrun``'s ``dryrun_multichip(2)`` and
  ``entry()`` on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.app import cli as tcli
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    REPROJECTION_MODE_ACCUMULATE,
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
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
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_tlas
from realtimepathtracingresearchframework_tpu_torch.parallel import dryrun
from realtimepathtracingresearchframework_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    replicate,
)
from realtimepathtracingresearchframework_tpu_torch.parallel.render_sharded import (
    build_sharded_render,
    build_sharded_render_2d,
)
from realtimepathtracingresearchframework_tpu_torch.utils.error_io import RenderError

from test_torch_render import _jax_renderer, _scene_arrays  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

CORNELL_CAM = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
ROUTE_ENV = ("RPTR_TRAVERSAL_V3", "RPTR_HOST_WAVEFRONT", "RPTR_COMPACT_LANES",
             "RPTR_TRAVERSAL_V1", "RPTR_FORCE_STREAMED_TRAVERSAL",
             "RPTR_STREAM_CLOSEST", "RPTR_COMPACT")


@pytest.fixture
def route_env(monkeypatch):
    for k in ROUTE_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# parallel.mesh
# ---------------------------------------------------------------------------


def test_make_mesh():
    assert make_mesh() == [torch.device(f"cuda:{i}")
                           for i in range(torch.cuda.device_count())]
    assert make_mesh(["cpu"] * 8) == [torch.device("cpu")] * 8
    grid = make_mesh_2d(2, 4, ["cpu"] * 9)
    assert [len(row) for row in grid] == [4, 4]
    with pytest.raises(ValueError, match="need 8 devices, have 7"):
        make_mesh_2d(2, 4, ["cpu"] * 7)


def _cornell_renderer(w, h, **kw):
    r = Renderer(device="cpu", **kw)
    r.initialize(w, h)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    return r


def _tlas_renderer(devices=None):
    r = Renderer(device="cpu", devices=devices, rays_per_pass=256)
    r.options = r.options.replace(use_tlas=True)
    r.initialize(32, 32)
    r.set_scene(Scene.from_vkr_scene(procedural.instanced_field(6, 4)),
                scene_config=SceneConfig(sun_dir=(0.4, 0.8, 0.25)))
    return r


def test_replicate_moves_tensor_leaves_only(monkeypatch):
    """Onto the ``meta`` device: every tensor leaf of a K7 scene moved, K7's
    static metadata (numpy, ints) the same objects; with a memo, a second
    call after a TLAS update copies only the frame's new tensors."""
    monkeypatch.setattr(traverse_tlas, "MAX_INSTANCES", 0)
    r = _tlas_renderer()
    assert r._route.tlas == "k7"
    ds = r.device_scene
    memo = {}
    rep = replicate(ds, "meta", memo)

    def leaves(tree, out):
        if isinstance(tree, torch.Tensor):
            out.append(tree)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                leaves(v, out)
        return out

    src, dst = leaves(ds, []), leaves(rep, [])
    assert len(src) == len(dst) > 20
    assert all(t.device.type == "meta" for t in dst)
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(src, dst))
    static, rstatic = ds.tlas_stream[0], rep.tlas_stream[0]
    for name in ("chunk_mesh", "chunk_node_base", "chunk_tile_base",
                 "chunk_obj_min", "chunk_obj_max", "mesh_chunk_start"):
        assert isinstance(getattr(rstatic, name), np.ndarray), name
        assert getattr(rstatic, name) is getattr(static, name), name
    assert type(rstatic.chunk_tris) is int and rstatic.num_chunks > 0
    assert type(rep.bvh) is type(ds.bvh) and type(rep.lights) is type(ds.lights)
    # a TLAS update: the static pack, attributes and lights are reused
    r.set_animation_frame(2)
    rep2 = replicate(r.device_scene, "meta", memo)
    assert rep2.tlas_stream[0].sub_nodes is rstatic.sub_nodes
    assert rep2.attr_packed is rep.attr_packed
    assert rep2.tlas_stream[1].top_nodes is not rep.tlas_stream[1].top_nodes
    assert len(memo) == len({id(t) for t in leaves(r.device_scene, [])})


# ---------------------------------------------------------------------------
# The sharded renders
# ---------------------------------------------------------------------------


def _frame_inputs(w, h, depth=3):
    r = _cornell_renderer(w, h)
    view = ti.ViewBuffers(*(torch.from_numpy(np.asarray(a, np.float32))
                            for a in CORNELL_CAM.view_basis(w, h)))
    fp = ti.FrameParams(rr_path_depth=2, glossy_only_mode=0, sample_offset=0,
                        shot_offset=0)
    return r, r._integrator_config(RenderParams(max_path_depth=depth)), fp, view


def test_sharded_render_matches_single_device():
    r, cfg, fp, view = _frame_inputs(32, 32)
    single, rays1 = ti.render_tile(r.device_scene, cfg, fp, view, 32, 32, 2)
    f = build_sharded_render(["cpu"] * 8, cfg, 32, 32)
    sharded, rays8 = f(r.device_scene, fp, view, 2)
    assert sharded.shape == (32, 32, 4)
    assert torch.equal(single, sharded)
    assert int(rays1) == rays8 > 0


def test_2d_mesh_matches_single_device():
    r, cfg, fp, view = _frame_inputs(64, 32)
    single, rays1 = ti.render_tile(r.device_scene, cfg, fp, view, 64, 32, 1)
    f = build_sharded_render_2d(make_mesh_2d(2, 4, ["cpu"] * 8), cfg, 64, 32)
    sharded, rays8 = f(r.device_scene, fp, view, 1)
    assert torch.equal(single, sharded)
    assert int(rays1) == rays8 > 0


def test_sharded_size_checks():
    r, cfg, _, _ = _frame_inputs(16, 12, depth=2)
    with pytest.raises(ValueError, match="height 12 not divisible by 8"):
        build_sharded_render(["cpu"] * 8, cfg, 16, 12)
    grid = make_mesh_2d(2, 4, ["cpu"] * 8)
    with pytest.raises(ValueError, match="not divisible by mesh"):
        build_sharded_render_2d(grid, cfg, 30, 32)
    with pytest.raises(ValueError, match="not divisible by mesh"):
        build_sharded_render_2d(grid, cfg, 32, 31)


def test_row_bands_match_jax_op_by_op():
    """The 48x48 cornell_diffuse golden frame as three row bands of 16 rows
    (``render_tile`` with ``y0`` 0, 16 and 32) at the golden's 4 spp,
    against the JAX package run op by op on the bands' pixels (frame
    coordinates) over the same scene arrays: ray counts per lane exact, the
    bands' rays their lanes' sum, band 16-31's first sample bitwise its
    lanes' own trace, and the frame the bands form at
    ``goldens.compare_ref``'s gate. The gate holds the whole frame, as in
    tests/test_torch_render.py: on one band alone a single NEE sample that
    the two packages' libm ulps flip moves the mean (one sample, rows 16-31:
    0.0057 against 0.0030 on a lane with equal rays, mean relative error
    8.3e-4; four samples, rows 32-47: 2.4e-4)."""
    w = h = goldens.SIZE
    th, bands = 16, (0, 16, 32)
    jr, cam, params, _ = _jax_renderer("cornell_diffuse")
    jds, jcfg = jr.device_scene, jr._integrator_config(params)
    tds = ti.device_scene_from_numpy(_scene_arrays(jr), "cpu")
    tcfg = ti.IntegratorConfig(max_path_depth=params.max_path_depth,
                               num_lights=jcfg.num_lights)
    basis = cam.view_basis(w, h)
    tview = ti.ViewBuffers(*(torch.from_numpy(a) for a in basis))
    jview = ji.ViewBuffers(*(jnp.asarray(a) for a in basis))
    frame, band_rays = [], 0
    for y0 in bands:
        band, rays = ti.render_tile(tds, tcfg, ti.FrameParams(), tview, w, h,
                                    goldens.SPP, y0=y0, tile_h=th)
        assert band.shape == (th, w, 4)
        frame.append(band[..., :3].numpy())
        band_rays += int(rays)
    tables = [ti.tile_tables(w, th, "cpu", 0, y0) for y0 in bands]
    px, py, valid = (torch.cat([torch.cat(t[k]) for t in tables])
                     for k in range(3))
    assert sorted(set(py[valid].tolist())) == list(range(h))
    vt = valid.numpy()
    jpx, jpy, jvalid = (jnp.asarray(t.numpy()) for t in (px, py, valid))
    port_rays = 0
    ref = np.zeros((h, w, 3), np.float32)
    for s in range(goldens.SPP):
        st = tps.make_state(0, s, 0, px, py, w)
        st, ro, rd = ti.camera_setup(tcfg, tview, px, py, (float(w), float(h)),
                                     st)
        rgb_t, _, rays_t = ti.trace_paths(tds, tcfg, ti.FrameParams(), ro, rd,
                                          st, lane_mask=valid)
        with jax.disable_jit():
            fp = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(0),
                                jnp.uint32(0))
            jst = jps.make_state(0, jnp.uint32(s), jnp.uint32(0), jpx, jpy, w,
                                 bufs=jds.rng)
            jst, jro, jrd = ji.camera_setup(
                jds, jcfg, fp, jview, jpx, jpy,
                jnp.array([w, h], jnp.float32), jst)
            rgb_j, _, rays_j = ji.trace_paths(jds, jcfg, fp, jro, jrd, jst,
                                              lane_mask=jvalid)
        np.testing.assert_array_equal(rays_t.numpy()[vt],
                                      np.asarray(rays_j)[vt])
        port_rays += int(rays_t.numpy()[vt].sum())
        lanes = np.stack([np.asarray(c) for c in rgb_j], -1)[vt]
        ref[py.numpy()[vt], px.numpy()[vt]] += lanes / goldens.SPP
        if s == 0:
            # a band's one-sample frame is its lanes' own trace, bitwise
            one, _ = ti.render_tile(tds, tcfg, ti.FrameParams(), tview, w, h,
                                    1, y0=16, tile_h=th)
            img = np.zeros((h, w, 3), np.float32)
            img[py.numpy()[vt], px.numpy()[vt]] = np.stack(
                [c.numpy() for c in rgb_t], -1)[vt]
            np.testing.assert_array_equal(one[..., :3].numpy(), img[16:32])
    assert band_rays == port_rays
    res = goldens.compare_ref(np.concatenate(frame), ref)
    assert res["ok"], res


# ---------------------------------------------------------------------------
# Renderer(devices=...)
# ---------------------------------------------------------------------------


def _terrain_scene():
    return (Scene.from_vkr_scene(procedural.terrain(grid=24)),
            OrientedCamera.look_at([0, 5.0, 12.0], [0, 0, 0], fovy=55),
            SceneConfig(sun_dir=(0.4, 0.7, 0.2), turbidity=3.0))


SCENES = {
    # name -> (single-renderer environment, both renderers' environment)
    "cornell": ({}, {}),
    "flat_cull": ({"RPTR_HOST_WAVEFRONT": "0"}, {"RPTR_TRAVERSAL_V3": "1"}),
    "streamed": ({}, {"RPTR_FORCE_STREAMED_TRAVERSAL": "1"}),
}


def _render_scene(name, devices, monkeypatch):
    """Two frames (cornell 64x64 at 1,024 rays a pass, the terrains 32x32
    at 256); returns (accumulation, display, renderer)."""
    single_env, env = SCENES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if devices is None:
        for k, v in single_env.items():
            monkeypatch.setenv(k, v)
    if name == "cornell":
        r = _cornell_renderer(64, 64, devices=devices, rays_per_pass=1024)
        cfg = FrameConfig(camera=CORNELL_CAM,
                          params=RenderParams(max_path_depth=3))
    else:
        scene, cam, sc = _terrain_scene()
        r = Renderer(device="cpu", devices=devices, rays_per_pass=256)
        r.initialize(32, 32)
        r.set_scene(scene, scene_config=sc)
        cfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=3),
                          scene_config=sc)
    for _ in range(2):
        r.render(cfg)
    for k in (*env, *single_env):
        monkeypatch.delenv(k, raising=False)
    return r.readback_accumulation(), r.readback_framebuffer(), r


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_multi_device_renderer_bit_identical(name, n, route_env):
    ref, fb_ref, r1 = _render_scene(name, None, route_env)
    acc, fb, r = _render_scene(name, ["cpu"] * n, route_env)
    assert r._multi and len(r._device_scenes) == n
    assert len(r._acc_chunks) >= 4  # every device renders a chunk
    assert r._route == r1._route
    if name == "flat_cull":
        assert r._route.kernel_v3 and r._wavefront is None
        assert r1._wavefront is None
    assert r._route.streamed == (name == "streamed")
    np.testing.assert_array_equal(acc, ref)
    np.testing.assert_array_equal(fb, fb_ref)
    assert r.last_frame_rays() == r1.last_frame_rays() > 0


@pytest.mark.parametrize("kernel", ["k6", "k7"])
@pytest.mark.parametrize("n", [2, 4])
def test_multi_device_animated_two_level(kernel, n, monkeypatch):
    """Three TLAS updates with a frame after each, on several devices and
    on one: bitwise, every replica holding the frame's TLAS side; on K7
    the static pack's metadata stays numpy and ints on every replica."""
    if kernel == "k7":
        monkeypatch.setattr(traverse_tlas, "MAX_INSTANCES", 0)
    cam = OrientedCamera.look_at([0, 14.0, 30.0], [0, 0, 0], fovy=55)
    cfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=3),
                      scene_config=SceneConfig(sun_dir=(0.4, 0.8, 0.25)))
    one, multi = _tlas_renderer(), _tlas_renderer(["cpu"] * n)
    assert one._route.tlas == multi._route.tlas == kernel
    for frame in (1, 2, 3):
        for r in (one, multi):
            r.set_animation_frame(frame)
            r.render(cfg)
        np.testing.assert_array_equal(multi.readback_accumulation(),
                                      one.readback_accumulation())
        for rep in multi._device_scenes:
            assert torch.equal(rep.tlas.inst_inv, one.device_scene.tlas.inst_inv)
            if kernel == "k6":
                assert torch.equal(rep.tlas_k6.inst_table,
                                   one.device_scene.tlas_k6.inst_table)
            else:
                assert torch.equal(rep.tlas_stream[1].entry_table,
                                   one.device_scene.tlas_stream[1].entry_table)
            if kernel == "k7":
                static = rep.tlas_stream[0]
                assert isinstance(static.chunk_mesh, np.ndarray)
                assert isinstance(static.mesh_chunk_start, np.ndarray)
                assert type(static.chunk_tris) is int
    np.testing.assert_array_equal(multi.readback_framebuffer(),
                                  one.readback_framebuffer())


def test_checkpoint_across_device_counts(tmp_path):
    """save_state of a 4-device renderer resumes in a single and a 2-device
    renderer: frame_id and image kept, the next frame bitwise the 4-device
    renderer's own next frame."""
    cfg = FrameConfig(camera=CORNELL_CAM, params=RenderParams(max_path_depth=3))
    r4 = _cornell_renderer(64, 64, devices=["cpu"] * 4, rays_per_pass=1024)
    for _ in range(2):
        r4.render(cfg)
    path = str(tmp_path / "ck.npz")
    r4.save_state(path)
    saved = r4.readback_accumulation()
    r4.render(cfg)
    for devices in (None, ["cpu"] * 2):
        r = _cornell_renderer(64, 64, devices=devices, rays_per_pass=1024)
        r.load_state(path)
        assert r.frame_id == 2
        np.testing.assert_array_equal(r.readback_accumulation(), saved)
        r.render(cfg)
        assert r.frame_id == 3
        np.testing.assert_array_equal(r.readback_accumulation(),
                                      r4.readback_accumulation())
        np.testing.assert_array_equal(r.readback_framebuffer(),
                                      r4.readback_framebuffer())


def test_first_device_paths_on_several_devices():
    """The paths that run on the first device (renderer.py:1442-1449): a
    planar frame, an image-domain frame (ACCUMULATE with an upscale of 2),
    a planar frame again (the image history re-swizzled and split over the
    devices), the ray queries, the AOVs and the ray-stats image, on 3
    devices bitwise the single renderer's."""
    out = []
    base = RenderParams(max_path_depth=3)
    image = base.replace(reprojection_mode=REPROJECTION_MODE_ACCUMULATE,
                         render_upscale_factor=2)
    rng = np.random.default_rng(3)
    origins = np.tile(np.float32([0, 1, 3]), (64, 1))
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2])
    for devices in (None, ["cpu"] * 3):
        r = _cornell_renderer(32, 32, devices=devices, rays_per_pass=256)
        seen = []
        for params in (base, image, base):
            r.render(FrameConfig(camera=CORNELL_CAM, params=params))
            seen += [r.readback_accumulation(), r.readback_framebuffer()]
        assert r._planar and {a[0].device for a in r._acc_chunks} == {
            torch.device("cpu")} and len(r._acc_chunks) == 4
        cfg = FrameConfig(camera=CORNELL_CAM, params=base)
        seen += list(r.render_ray_queries(origins, dirs))
        seen.append(r.render_ray_queries(origins, dirs,
                                         variant="PT_MEGAKERNEL"))
        r.render_aovs(cfg)
        seen += [r.readback_aov(k) for k in range(3)]
        seen.append(r.render_ray_stats(cfg))
        out.append(seen)
    assert len(out[0]) == len(out[1]) == 15
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_warmup_runs_on_every_device(monkeypatch):
    calls = []
    make = trend.make_pass_fn

    def counted(ds, *args):
        calls.append(ds)
        return make(ds, *args)

    r = _cornell_renderer(32, 32, devices=["cpu"] * 3, rays_per_pass=256)
    monkeypatch.setattr(trend, "make_pass_fn", counted)
    r.warmup_async().join()
    r._join_warmup()
    assert len(calls) == 3 and all(ds is not None for ds in calls)
    assert r.frame_id == 0


def test_multi_card_frames_timed_by_the_window(monkeypatch):
    """On several cards frames are timed by the host clock over each
    sync_interval window (stood in for on the CPU): until the first window
    ends each call's wall, then the window's mean."""
    r = _cornell_renderer(16, 16, devices=["cpu"] * 2)
    assert not r._times_by_events() and not r._times_by_window()
    monkeypatch.setattr(r, "_times_by_window", lambda: True)
    r.sync_interval = 2
    cfg = FrameConfig(camera=CORNELL_CAM, params=RenderParams(max_path_depth=2))
    s1 = r.render(cfg)
    assert s1.render_time > 0 and r._frames_since_sync == 1
    assert not r._window_closed and r._win_t0 is not None
    r.render(cfg)
    assert r._window_closed and r._frames_since_sync == 0 and r._win_t0 is None
    r.render(cfg)
    window = r._last_render_ms
    assert r.stats(force_rays=True).render_time > 0  # closes the window
    assert r._frames_since_sync == 0 and r._last_render_ms != window


# ---------------------------------------------------------------------------
# The CLI and the entry points
# ---------------------------------------------------------------------------


def test_cli_devices_renders_the_same_png(tmp_path, monkeypatch):
    base = ["cornell", "--backend", "cpu", "--img", "16", "16",
            "--max-depth", "2", "--disable-ui", "--png"]
    outs = {}
    for n in (1, 2):
        d = tmp_path / f"n{n}"
        d.mkdir()
        monkeypatch.chdir(d)
        assert tcli.main(base + ["--devices", str(n)]) == 0
        outs[n] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert outs[1] and outs[1] == outs[2]
    assert any(name.endswith(".png") for name in outs[2])


def test_cli_cuda_devices_above_the_card_count_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RenderError, match="--devices 2 but only 1 devices"):
        tcli.main(["cornell", "--img", "8", "8", "--devices", "2",
                   "--disable-ui"])
    assert not list(tmp_path.iterdir())


def test_dryrun_multichip_and_entry_on_cpu(capsys):
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert out["accum"].shape == (4, 16, 4) and out["rays"] > 0
    assert out["accum2"].shape == (4, 16, 4) and out["rays2"] > 0
    assert "dryrun_multichip: OK on 2 devices (1 distinct: cpu)" in (
        capsys.readouterr().out)
    fn, args = dryrun.entry(device="cpu")
    img = fn(*args)
    assert img.shape == (32, 32, 4) and torch.isfinite(img).all()
    assert float(img[..., :3].mean()) > 0
