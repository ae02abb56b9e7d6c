"""The fused ``rptr.shade`` stage (``ops/shade.py``, ``csrc/shade.cu``).

On the CPU:
- the plain versions of ``shade_hit`` and ``shade_scatter``, run by
  ``visit_hit`` and ``scatter_tail``, give the frames of the eager code they
  replaced bit for bit: each case's frame digest (sha256 of its f32 bytes)
  was taken from that code on the same tiny scenes: ``procedural.village(24)``
  (textured, the flat-cull route) and ``procedural.terrain(16)`` (untextured,
  the streamed route) at 32x32, depth 4, sample 0 of one chunk through
  ``trace_paths``, textured and untextured, sun and sky on and off, glossy
  only, the wavefront variant, and a whole frame through the executor;
- the route rule: two-level scenes, thin transmission and anisotropic taps
  take the plain stage, every other configuration the kernels;
- the counter of shaded bounces by path and ``Renderer.shade_fused_share``
  read what the rule decided;
- the wrappers' operand tables match the kernels' (the enums of
  csrc/shade.cu), and the table layout the kernels are compiled for (its
  constexprs and ``rptr_shade_layout``'s order) is ``shade_common.LAYOUT``.

On a card (marked ``cuda``, skipped without one): both kernels against
their plain versions on the bounce-0 and bounce-1 carries of a 1080p chunk,
lane for lane: the village (textured) and terrain500 (untextured), the
village under RIS light selection (the binned light count of the emitter's
MIS) and in the wavefront variant (the deferred shadow queue and its origin
rule), and cornell with a glass material (the transmission lobe) with the
sun and sky off and in the glossy-only mode. ``chip_smoke.py``'s fused
shading phase times them too.
"""

import hashlib
import os
import re

import numpy as np
import pytest
import torch

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
from realtimepathtracingresearchframework_tpu_torch.ops import integrator
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
from realtimepathtracingresearchframework_tpu_torch.ops import shade
from realtimepathtracingresearchframework_tpu_torch.ops import shade_common
from realtimepathtracingresearchframework_tpu_torch.utils import profiling

torch.set_num_threads(1)  # see tests/test_torch_render.py

SIZE = 32
ENV = ("RPTR_TRAVERSAL_V3", "RPTR_HOST_WAVEFRONT",
       "RPTR_FORCE_STREAMED_TRAVERSAL", "RPTR_STREAM_CLOSEST",
       "RPTR_COMPACT_LANES", "RPTR_COMPACT", "RPTR_KERNEL_V4",
       "RPTR_TRAVERSAL_V1")
SCENES = {
    # name: (environment, scene, (eye, center), sun)
    "village": ({"RPTR_TRAVERSAL_V3": "1", "RPTR_HOST_WAVEFRONT": "1"},
                lambda: procedural.village(grid=24),
                ([0, 4.0, 13.0], [0, 0.5, 0]), (0.35, 0.8, 0.3)),
    "terrain": ({"RPTR_FORCE_STREAMED_TRAVERSAL": "1"},
                lambda: procedural.terrain(grid=16),
                ([0, 5.0, 12.0], [0, 0, 0]), (0.4, 0.7, 0.2)),
}
# case: (scene, IntegratorConfig changes, FrameParams changes, the digest of
# the eager code's frame); no changes (None): a whole Renderer frame
CASES = {
    "village": ("village", {}, {}, "a0eb7a84dcc64688"),
    "village-untextured": ("village", {"has_textures": False}, {},
                           "0264527f6c6f12ad"),
    "village-sun-off": ("village", {"enable_sun_sky": False}, {},
                        "b0e9baf90a94a24c"),
    "village-glossy-only": ("village", {}, {"glossy_only_mode": 1},
                            "53a4818bc449105c"),
    "village-wavefront": ("village", {"wavefront": True}, {},
                          "a0eb7a84dcc64688"),
    "terrain": ("terrain", {}, {}, "f1145e3417d419f2"),
    "terrain-sun-off": ("terrain", {"enable_sun_sky": False}, {},
                        "1f67dc0fd063bf4c"),
    "terrain-wavefront": ("terrain", {"wavefront": True}, {},
                          "f1145e3417d419f2"),
    "village-executor": ("village", None, None, "2cf15927f32cfa3e"),
}


def _renderer(scene, monkeypatch):
    env, build, (eye, center), sun = SCENES[scene]
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    r = Renderer(device="cpu")
    r.initialize(SIZE, SIZE)
    sc = SceneConfig(sun_dir=sun)
    r.set_scene(Scene.from_vkr_scene(build()), scene_config=sc)
    frame = FrameConfig(camera=OrientedCamera.look_at(eye, center, fovy=50.0),
                        params=RenderParams(max_path_depth=4), scene_config=sc)
    return r, frame


@pytest.fixture(scope="module")
def renderers():
    mp = pytest.MonkeyPatch()
    try:
        return {s: _renderer(s, mp) for s in SCENES}
    finally:
        mp.undo()


def _trace(r, frame, cfg, fp):
    """Sample 0 of chunk 0 through ``trace_paths``: (illum, alpha, rays)."""
    dims = (float(SIZE), float(SIZE))
    px, py, valid = (x[0] for x in r._swizzle)
    view = r._view(frame.camera)
    ds = r.device_scene
    state = pointsets.make_state(cfg.rng_variant, 0, 0, px, py, SIZE, bufs=ds.rng)
    state, ro, rd = integrator.camera_setup(cfg, view, px, py, dims, state,
                                            bufs=ds.rng, fp=fp)
    return integrator.trace_paths(
        ds, cfg, fp, ro, rd, state, lane_mask=valid,
        footprint0=integrator.camera_footprint0(cfg, fp, view, dims, rd))


def _frame(renderers, case):
    scene, cfg_changes, fp_changes, _ = CASES[case]
    r, frame = renderers[scene]
    if cfg_changes is None:
        r.reset_accumulation()
        r.render(frame)
        return r.readback_accumulation()
    cfg = r._integrator_config(frame.params)._replace(**cfg_changes)
    fp = integrator.FrameParams(bump_scale=float(frame.scene_config.bump_scale))
    illum, alpha, rays = _trace(r, frame, cfg, fp._replace(**fp_changes))
    return np.concatenate([torch.stack(list(illum), -1).numpy().ravel(),
                           alpha.numpy().ravel(),
                           rays.numpy().astype(np.float32).ravel()])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_stage_is_the_eager_codes_frame(renderers, case):
    """The plain versions' frame, bit for bit the eager code's."""
    img = np.ascontiguousarray(_frame(renderers, case), np.float32)
    assert np.isfinite(img).all()
    digest = hashlib.sha256(img.tobytes()).hexdigest()[:16]
    assert digest == CASES[case][3]


@pytest.mark.parametrize("change, want", [
    ({}, True),
    ({"has_textures": True, "wavefront": True, "streamed": True}, True),
    ({"enable_sun_sky": False, "has_transmission": False}, True),
    ({"use_light_bins": True, "num_lights": 16, "alpha_test": True}, True),
    ({"kernel_v3": True, "compact_lanes": True, "debug_mode": 3}, True),
    ({"traversal_v1": True, "rng_variant": 2, "enable_dof": True}, True),
    ({"two_level": True, "tlas_k6": True}, False),
    ({"two_level": True, "tlas_stream": True}, False),
    ({"thin_transmission": True}, False),
    ({"has_textures": True, "aniso_taps": 4}, False),
    ({"aniso_taps": 1}, False),
])
def test_route_rule(change, want):
    """The kernels implement every configuration but two-level scenes,
    thin transmission and anisotropic taps."""
    cfg = integrator.IntegratorConfig()._replace(**change)
    assert shade.fused(cfg) is want


@pytest.mark.parametrize("change, fused", [
    ({}, True),
    ({"thin_transmission": True}, False),
    ({"aniso_taps": 4}, False),
])
def test_counter_reads_the_route(renderers, monkeypatch, change, fused):
    """Each visit counts one shaded bounce on the path the rule chose; the
    wrappers run where it chose the kernels, the plain versions directly
    where it did not."""
    calls = {"shade_hit": 0, "shade_scatter": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(shade, name, spy(name, getattr(shade, name)))
    r, frame = renderers["village"]
    cfg = r._integrator_config(frame.params)._replace(**change)
    fp = integrator.FrameParams(bump_scale=float(frame.scene_config.bump_scale))
    profiling.reset_shaded()
    visits = []
    visit, scatter = integrator._make_bounce_fns(r.device_scene, cfg, fp)
    dims = (float(SIZE), float(SIZE))
    px, py, valid = (x[0] for x in r._swizzle)
    view = r._view(frame.camera)
    ds = r.device_scene
    state = pointsets.make_state(0, 0, 0, px, py, SIZE, bufs=ds.rng)
    state, ro, rd = integrator.camera_setup(cfg, view, px, py, dims, state,
                                            bufs=ds.rng, fp=fp)
    carry = integrator.initial_carry(
        ro, rd, state, valid,
        foot=integrator.camera_footprint0(cfg, fp, view, dims, rd))
    for b in range(3):
        carry, ctx = visit(carry)
        visits.append(b)
        carry = scatter(carry, ctx, b)
    counts = dict(profiling.shaded_bounces)
    assert counts == {"fused" if fused else "plain": len(visits)}
    assert profiling.fused_shade_share() == (100.0 if fused else 0.0)
    assert calls == ({"shade_hit": 3, "shade_scatter": 3} if fused
                     else {"shade_hit": 0, "shade_scatter": 0})


@pytest.mark.parametrize("scene, options, share", [
    ("village", {}, 100.0),
    ("terrain", {}, 100.0),
    ("village", {"aniso_taps": 4}, 0.0),
    ("instanced", {"use_tlas": True}, 0.0),
])
def test_renderer_fused_share(monkeypatch, scene, options, share):
    """``Renderer.shade_fused_share``: the percent of the last frame's
    shaded bounces on the fused path, reset every frame, a public number
    (the benchmark collects the renderer's public numbers)."""
    if scene == "instanced":
        for k in ENV:
            monkeypatch.delenv(k, raising=False)
        r = Renderer(device="cpu")
        r.options = r.options.replace(**options)
        r.initialize(SIZE, SIZE)
        r.set_scene(Scene.from_vkr_scene(
            procedural.instanced_field(num_inst=6, frames=4)))
        frame = FrameConfig(
            camera=OrientedCamera.look_at([0, 14.0, 30.0], [0, 0, 0], fovy=55),
            params=RenderParams(max_path_depth=3))
        assert r._route.tlas
    else:
        r, frame = _renderer(scene, monkeypatch)
        r.options = r.options.replace(**options)
    assert r.shade_fused_share == 0.0
    profiling.count_shaded(share == 0.0)  # a stale count: reset per frame
    r.render(frame)
    assert profiling.shaded_bounces["fused" if share else "plain"] > 0
    assert r.shade_fused_share == share
    assert "shade_fused_share" in vars(r)


def _kernel_source():
    src = os.path.join(os.path.dirname(shade.__file__), os.pardir, "csrc",
                       "shade.cu")
    with open(src) as f:
        return f.read()


def _enum_sections(name):
    """The sections of ``enum <name>`` in csrc/shade.cu, split at its
    comment lines: [[names of the inputs], [names after the first comment],
    ...], the closing count left out."""
    body = re.search(r"enum %s \{(.*?)\};" % name, _kernel_source(),
                     re.S).group(1)
    sections = [[]]
    for line in body.splitlines():
        if line.strip().startswith("//"):
            sections.append([])
            continue
        sections[-1] += [t.strip() for t in line.split(",") if t.strip()]
    assert sections[-1][-1].endswith("_NPTR")
    sections[-1].pop()
    return sections


@pytest.mark.parametrize("kind", ["HitPtr", "ScatterPtr"])
def test_operand_tables_match_the_kernels(kind):
    """The wrappers' operand tables and csrc/shade.cu's enums: the same
    sections (inputs, tables, f32 outputs, other outputs), each of the same
    length."""
    if kind == "HitPtr":
        sections = (shade.HIT_IN, shade.HIT_TABLES, shade.HIT_FLOAT_OUT,
                    shade.HIT_OTHER_OUT)
    else:
        sections = (shade.SCATTER_IN, shade.SCATTER_FLOAT_OUT,
                    shade.SCATTER_OTHER_OUT)
    assert [len(s) for s in _enum_sections(kind)] == [len(s) for s in sections]


def test_kernel_layout_is_shade_common_layout():
    """csrc/shade.cu's table layout constexprs hold ``shade_common.LAYOUT``'s
    numbers, and ``rptr_shade_layout`` reports them in LAYOUT's order (the
    wrapper compares that report with LAYOUT when it loads the library)."""
    src = _kernel_source()
    consts = {}
    for kind, decl in re.findall(r"^constexpr (int|double) (.*?);", src, re.M):
        for item in decl.split(","):
            name, value = (x.strip() for x in item.split("="))
            consts[name] = (kind, value)
    found = {}
    for name in shade_common.LAYOUT:
        kind, value = consts[name]
        found[name] = int(value, 0) if kind == "int" else float(value)
    assert found == shade_common.LAYOUT
    body = re.search(r"rptr_shade_layout\(.*?\{(.*?)\};", src, re.S).group(1)
    order = [t.strip() for t in body.split("{", 1)[1].split(",")]
    assert order == list(shade_common.LAYOUT)


def test_wrappers_run_the_plain_versions_on_the_cpu(renderers, monkeypatch):
    """On CPU tensors the wrappers never load the kernels' library."""
    def no_library():
        raise AssertionError("the CPU path loaded csrc/shade.cu")

    monkeypatch.setattr(shade, "_lib", no_library)
    shade.reset_launches()
    _frame(renderers, "village")
    assert shade.launches == {"shade_hit": 0, "shade_scatter": 0}


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def glass(ds):
    """``ds`` with its first material (cornell's white) a smooth glass, so
    that its lanes take the transmission lobe and pass the glossy-only
    mask."""
    m = ds.mat_packed.clone()
    m[shade_common._M_STRANS, 0] = 0.9
    m[shade_common._M_IOR, 0] = 1.5
    m[shade_common._M_ROUGH, 0] = 0.05
    m[shade_common._M_METAL, 0] = 0.0
    return ds._replace(mat_packed=m)


# id: (frame_setup scene, grid and options, IntegratorConfig changes,
# FrameParams changes, glass); every one at 1080p, chunk 2
CARD_CASES = {
    "village-200": ("village", {"grid": 200}, {}, {}, False),
    "terrain-500": ("terrain", {"grid": 500}, {}, {}, False),
    "village-ris": ("village", {"grid": 200, "ris": True}, {}, {}, False),
    "village-wavefront": ("village", {"grid": 200}, {"wavefront": True}, {},
                          False),
    "cornell-glass-sun-off": ("cornell", {}, {"enable_sun_sky": False}, {},
                              True),
    "cornell-glass-glossy-only": ("cornell", {}, {}, {"glossy_only_mode": 1},
                                  True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernels_equal_plain_versions_on_the_card(case):
    """Both kernels against their plain versions on the bounce-0 and
    bounce-1 carries of chunk 2 of the 1080p frame, every field bit for
    bit on every lane; prints the fields that differ and the launches."""
    dev = _card()
    from realtimepathtracingresearchframework_tpu_torch.profile_frame import (
        frame_setup,
    )

    scene, setup, cfg_changes, fp_changes, with_glass = CARD_CASES[case]
    r, fc = frame_setup(scene, str(dev), (1920, 1080), **setup)
    cfg = r._integrator_config(fc.params)._replace(
        compact=False, compact_lanes=False, **cfg_changes)
    assert shade.fused(cfg)
    fp = integrator.FrameParams(bump_scale=float(fc.scene_config.bump_scale),
                                **fp_changes)
    dims = (1920.0, 1080.0)
    px, py, valid = (x[2] for x in r._swizzle)
    view = r._view(fc.camera)
    ds = glass(r.device_scene) if with_glass else r.device_scene
    state = pointsets.make_state(cfg.rng_variant, 0, 0, px, py, 1920,
                                 bufs=ds.rng)
    state, ro, rd = integrator.camera_setup(cfg, view, px, py, dims, state,
                                            bufs=ds.rng, fp=fp)
    carry = integrator.initial_carry(
        ro, rd, state, valid,
        foot=integrator.camera_footprint0(cfg, fp, view, dims, rd),
        wavefront=cfg.wavefront)
    kernels = shade.shade_hit, shade.shade_scatter
    found = []

    def both(kernel, plain):
        def fn(*args):
            got, want = kernel(*args), plain(*args)
            found.append(shade.differences(got, want))
            return want
        return fn

    shade.reset_launches()
    try:
        shade.shade_hit = both(kernels[0], shade.shade_hit_plain)
        shade.shade_scatter = both(kernels[1], shade.shade_scatter_plain)
        visit, scatter = integrator._make_bounce_fns(ds, cfg, fp)
        for b in range(2):
            carry, ctx = visit(carry)
            carry = scatter(carry, ctx, b)
    finally:
        shade.shade_hit, shade.shade_scatter = kernels
    print(f"{case}: fields that differ per launch {found}; launches "
          f"{shade.launches}")
    assert shade.launches == {"shade_hit": 2, "shade_scatter": 2}
    assert found == [{}] * 4
