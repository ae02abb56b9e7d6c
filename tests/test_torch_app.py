"""The port's app shell on the CPU, against the JAX package's.

- Modes: both packages' ``app.cli.main`` on the same argv at 16x16, depth 2
  (the CLI's default binned RIS light sampling): ``--validation`` at 4 spp,
  ``--profiling`` over 4 frames, ``--data-capture`` at 1 spp with 2
  POI-derived viewpoints, and ``--disable-ui``; the JAX side op by op
  (``jax.disable_jit``), the port with ``--backend cpu``. The same file
  names; every image (validation PFM, capture EXRs, the single shot) with
  at most 1% of pixels over 1e-4 (relative above 1); the profiling CSV's
  header byte-equal, with the same row count.
- Data capture (``app/datacapture.py``): POIs, pruned POIs and views
  exactly equal from the same seed when both modules query the same
  renderer. Across the two renderers (the JAX one op by op) the POI count
  is equal and the POIs and views within 1e-6: a hit's t differs in its
  last bits between the JAX package's XLA walk and the port's
  (``tests/test_torch_queries.py``), which moves a point by an ulp. POI
  radiance within 1e-4 (the JAX queries jitted).
  ``tests/test_modes_features.py``'s data-capture cases run on the port.
- ``Renderer.warmup_async``: a frame after the warm-up is bitwise the frame
  without it, the warm-up draws no sample, and its exception comes back
  from ``render``. ``Renderer.sync_interval``: with CUDA events stood in
  for on the CPU, at 1 each call's ``stats().render_time`` is its own
  frame's, and at the default 16 a call returns without waiting.
- ``kernels/build.py`` from two threads with a stub nvcc: one build, one
  ``CDLL``, no error. The CLI's ``--backend`` and ``--devices`` errors, and
  the relaunch watcher over the CUDA sources.
"""

import functools
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import test_modes_features as ref_modes  # noqa: E402
from test_torch_imstate import port_case  # noqa: E402
from realtimepathtracingresearchframework_tpu.app import cli as jcli
from realtimepathtracingresearchframework_tpu.app import datacapture as jdc
from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams as JaxRenderParams,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    Renderer as JaxRenderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu_torch.app import cli as tcli
from realtimepathtracingresearchframework_tpu_torch.app import datacapture as tdc
from realtimepathtracingresearchframework_tpu_torch.app import relaunch
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RenderParams,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.kernels import build
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.utils import image_io
from realtimepathtracingresearchframework_tpu_torch.utils.error_io import RenderError

# One torch thread per test process: the tier-1 run has six xdist workers
# on the machine's cores, and torch's OpenMP threads then oversubscribe them
torch.set_num_threads(1)

SIZE, DEPTH = 16, 2
BASE = ["cornell", "--backend", "cpu", "--img", str(SIZE), str(SIZE),
        "--max-depth", str(DEPTH)]
MODES = {
    "validation": ["--validation", "v", "--validation-spp", "4"],
    "profiling": ["--profiling", "p", "--profiling-frames", "4"],
    "data_capture": ["--data-capture", "d", "--data-capture-spp", "1",
                     "--data-capture-viewpoints", "2"],
    "disable_ui": ["--disable-ui"],
}


@pytest.fixture(scope="module")
def mode_runs(tmp_path_factory):
    """mode -> (JAX directory, port directory), each holding what that
    package's CLI wrote for the mode."""
    out = {}
    cwd = os.getcwd()
    try:
        for mode, argv in MODES.items():
            dirs = []
            for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
                d = tmp_path_factory.mktemp(f"{mode}_{tag}")
                os.chdir(d)
                if tag == "jax":
                    with jax.disable_jit():
                        assert main(BASE + argv) == 0
                else:
                    assert main(BASE + argv) == 0
                dirs.append(d)
            out[mode] = tuple(dirs)
    finally:
        os.chdir(cwd)
    return out


def _read(path):
    if path.suffix == ".pfm":
        return image_io.read_pfm(str(path))
    return image_io.read_exr_rgba(str(path))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_outputs_match_jax(mode, mode_runs):
    jdir, tdir = mode_runs[mode]
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir()) and names
    for name in names:
        if name.endswith(".csv"):
            continue
        ref, port = _read(jdir / name), _read(tdir / name)
        assert port.shape == ref.shape and np.isfinite(port).all(), name
        err = np.abs(port - ref) / np.maximum(np.abs(ref), 1.0)
        share = float((err.max(axis=-1) > 1e-4).mean())
        assert share <= 0.01, (name, share, float(err.max()))


def test_mode_file_names(mode_runs):
    names = {m: sorted(p.name for p in mode_runs[m][1].iterdir()) for m in MODES}
    assert names["validation"] == ["v_0004.pfm"]
    assert names["profiling"] == ["p.csv"]
    assert names["disable_ui"] == ["out.exr"]
    kinds = ("albedo_roughness", "motion_jitter", "normal_depth", "rgba")
    assert names["data_capture"] == sorted(
        f"d_{k}_{a}.exr" for k in ("0000", "0001", "vp00", "vp01") for a in kinds)


def test_profiling_csv_matches_jax(mode_runs):
    jdir, tdir = mode_runs["profiling"]
    ref = (jdir / "p.csv").read_text().splitlines()
    port = (tdir / "p.csv").read_text().splitlines()
    assert port[0] == ref[0]
    assert port[0].startswith(
        "frames_total, keyframe, frames_accumulated, render_time_ms, "
        "app_time_ms, buildblas_avg_ms")
    assert len(port) == len(ref) == 5
    cols = port[0].split(", ")
    for i, row in enumerate(port[1:]):
        vals = row.split(", ")
        assert len(vals) == len(cols)
        assert int(vals[0]) == i + 1 and float(vals[3]) > 0.0
        # the keyframe and accumulation columns follow the same timeline
        assert vals[1:3] == ref[i + 1].split(", ")[1:3]


# ---------------------------------------------------------------------------
# Data capture
# ---------------------------------------------------------------------------


def _cornell(device="cpu", size=SIZE):
    r = Renderer(device=device)
    r.initialize(size, size)
    r.set_scene(Scene.from_vkr_scene(tproc.cornell_box()))
    return r


@pytest.fixture(scope="module")
def jax_cornell():
    r = JaxRenderer()
    r.initialize(SIZE, SIZE)
    r.set_scene(JaxScene.from_vkr_scene(jproc.cornell_box()))
    return r


def _pois(p):
    return (np.stack([x.position for x in p]), np.stack([x.normal_hint for x in p]))


def test_capture_views_exact_on_the_same_hits():
    """Both modules over one renderer from the same seeds: POIs, the
    pruned set and the views bitwise equal."""
    r = _cornell()
    src = np.array([0.0, 1.0, 0.0], np.float32)
    out = []
    for dc in (jdc, tdc):
        rng = np.random.default_rng(11)
        pois = dc.collect_visible_points(r, src, 300, rng)
        pruned = dc.prune_pois(r, pois, rng, min_separation=0.1, max_pois=64)
        view = dc.sample_viewpoint(r, pruned, rng, min_dist=0.05, max_dist=5.0)
        views = dc.generate_capture_views(
            r, [src, np.array([0.3, 1.2, 2.0], np.float32)],
            num_pois_per_perspective=200, num_views=4, seed=5)
        out.append((pois, pruned, [view] + views))
    (jp, jpr, jv), (tp, tpr, tv) = out
    assert len(jp) == len(tp) > 100 and 10 < len(jpr) == len(tpr) <= 64
    for a, b in ((jp, tp), (jpr, tpr)):
        for x, y in zip(_pois(a), _pois(b)):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.dir, b.dir)


def test_capture_views_across_renderers(jax_cornell, mode_runs):
    """The JAX renderer (op by op) and the port's from the same seed: the
    same POI count and triangles, positions and views within 1e-6."""
    r = _cornell()
    src = np.array([0.0, 1.0, 0.0], np.float32)
    with jax.disable_jit():
        jp = jdc.collect_visible_points(jax_cornell, src, 256,
                                        np.random.default_rng(7))
        jv = jdc.generate_capture_views(jax_cornell, [src],
                                        num_pois_per_perspective=128,
                                        num_views=2, seed=1)
    tp = tdc.collect_visible_points(r, src, 256, np.random.default_rng(7))
    tv = tdc.generate_capture_views(r, [src], num_pois_per_perspective=128,
                                    num_views=2, seed=1)
    assert len(jp) == len(tp) > 64
    for x, y in zip(_pois(jp), _pois(tp)):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.pos, a.pos, rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.dir, a.dir, rtol=0, atol=1e-6)


def test_poi_radiance_matches_jax(jax_cornell):
    """The full-integrator capture at the same POIs, 2 samples a query at
    depth 2: within 1e-4 of the JAX renderer's jitted queries (measured
    1.3e-6)."""
    r = _cornell()
    pois = tdc.collect_visible_points(r, np.array([0.0, 1.0, 0.0], np.float32),
                                      64, np.random.default_rng(7))[:16]
    ref = jdc.capture_poi_radiance(jax_cornell, pois, spp_per_query=2,
                                   params=JaxRenderParams(max_path_depth=DEPTH))
    port = tdc.capture_poi_radiance(r, pois, spp_per_query=2,
                                    params=RenderParams(max_path_depth=DEPTH))
    assert port.shape == ref.shape == (16, 4) and port[:, :3].max() > 0.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-4)


DC_CASES = ["test_collect_and_prune_pois", "test_sample_viewpoint_is_unoccluded",
            "test_generate_capture_views", "test_capture_poi_radiance"]


@pytest.mark.parametrize("case", DC_CASES)
def test_reference_datacapture_case_on_port(case, monkeypatch):
    fn = port_case(ref_modes, case, monkeypatch, modules=("app.datacapture",),
                   Renderer=functools.partial(Renderer, device="cpu"),
                   Scene=Scene, procedural=tproc, RenderParams=RenderParams,
                   FrameConfig=FrameConfig, OrientedCamera=OrientedCamera)
    fn()


# ---------------------------------------------------------------------------
# warmup_async and sync_interval
# ---------------------------------------------------------------------------


def _frame_config():
    cam = OrientedCamera.look_at([0.0, 1.0, 3.2], [0.0, 1.0, 0.0], fovy=50.0)
    return FrameConfig(camera=cam, params=RenderParams(max_path_depth=DEPTH))


def test_warmup_frame_is_bitwise_the_frame_without():
    cfg = _frame_config()
    plain = _cornell()
    for _ in range(2):
        plain.render(cfg)
    joined, pending = _cornell(), _cornell()
    th = joined.warmup_async(cfg.params)
    assert isinstance(th, threading.Thread)
    th.join(timeout=120)
    assert not th.is_alive()
    assert joined.frame_id == 0 and joined.shot_offset == 0
    assert not joined.readback_accumulation().any()  # no sample drawn
    pending.warmup_async(cfg.params)  # joined by the first render
    for r in (joined, pending):
        for _ in range(2):
            r.render(cfg)
        assert r._warmup is None
        assert (r.readback_accumulation().tobytes()
                == plain.readback_accumulation().tobytes())
        assert (r.readback_framebuffer().tobytes()
                == plain.readback_framebuffer().tobytes())


def test_warmup_error_is_raised_by_render(monkeypatch):
    r = _cornell()

    def broken(*args, **kwargs):
        raise ValueError("warm-up pass failed")

    monkeypatch.setattr(trend, "make_pass_fn", broken)
    th = r.warmup_async()
    th.join(timeout=60)
    assert not th.is_alive()
    with pytest.raises(ValueError, match="warm-up pass failed"):
        r.render(_frame_config())
    monkeypatch.undo()
    r.render(_frame_config())  # reported once; the renderer still works
    assert r.frame_id == 1


def test_route_kernels_names_each_route():
    Route = trend.Route
    assert trend.route_kernels(trend.route_for(32)) == ["traverse_resident"]
    assert trend.route_kernels(Route(True, True, 32)) == [
        "traverse_flat_cull", "traverse_precull"]
    assert trend.route_kernels(Route(False, False, 64, streamed=True)) == [
        "traverse_streamed", "traverse_binned"]
    assert trend.route_kernels(Route(False, False, 128, v1=True)) == ["traverse_v1"]
    assert trend.route_kernels(Route(False, False, 32, tlas="k6")) == ["traverse_tlas"]
    assert trend.route_kernels(Route(False, False, 32, tlas="k7")) == [
        "traverse_tlas_stream"]
    for route in ("traverse_resident", "traverse_flat_cull", "traverse_v1"):
        assert (build.CSRC_DIR / f"{route}.cu").exists()


class _StandInEvent:
    """A CUDA event stood in for on the CPU: a recorded event completes
    only when something waits for it, and its elapsed time is the stamp
    of the end event, so a time names the frame it came from."""

    made = []
    clock = 0

    def __init__(self, enable_timing=True):
        self.done, self.stamp = False, None
        _StandInEvent.made.append(self)

    def record(self):
        _StandInEvent.clock += 1
        self.stamp = _StandInEvent.clock

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done
        return float(end.stamp)


@pytest.mark.parametrize("interval", [1, 16])
def test_sync_interval(interval, monkeypatch):
    r = _cornell()
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    monkeypatch.setattr(r, "_times_by_events", lambda: True)
    assert r.sync_interval == Renderer.SYNC_INTERVAL == 16
    r.sync_interval = interval
    cfg = _frame_config()
    for f in range(1, 5):
        stats = r.render(cfg)
        end = _StandInEvent.made[-1]
        if interval == 1:
            # each call waited for its own frame and returns its time
            assert end.done and stats.render_time == end.stamp
            assert r.stats().render_time == end.stamp
        else:
            # no wait: no frame has completed, so no time yet
            assert not end.done and stats.render_time == 0.0
    if interval == 16:
        # force_rays waits for the last frame
        assert r.stats(force_rays=True).render_time == _StandInEvent.made[-1].stamp


# ---------------------------------------------------------------------------
# kernels/build.py across threads
# ---------------------------------------------------------------------------


def test_build_and_load_from_two_threads(tmp_path, monkeypatch):
    """Two threads build and load one library through a stub nvcc (a
    script that copies a loadable shared object to its -o path, slowly):
    one build, both get the same CDLL at the library's path, no error and
    no temporary file left."""
    import _ctypes

    calls = tmp_path / "calls"
    stub = tmp_path / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys, time\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        "time.sleep(0.5)\n"
        f"shutil.copy({_ctypes.__file__!r}, sys.argv[sys.argv.index('-o') + 1])\n")
    stub.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(stub))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_loaded", {})
    libs, errors = [], []

    def worker():
        try:
            libs.append(build.load("traverse_resident"))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(libs) == 2 and libs[0] is libs[1]
    assert libs[0]._name == str(build.library_path("traverse_resident"))
    assert calls.read_text() == "x"
    assert [p.name for p in (tmp_path / "kernels").iterdir()] == [
        build.library_path("traverse_resident").name]


# ---------------------------------------------------------------------------
# CLI devices, relaunch watcher
# ---------------------------------------------------------------------------


def test_cli_cuda_backend_has_no_fallback(tmp_path, monkeypatch):
    """The default backend is the card: without one the CLI raises, it
    does not render on the CPU."""
    monkeypatch.chdir(tmp_path)
    args = tcli.build_parser().parse_args(["cornell"])
    assert args.backend == "cuda" and args.devices == 1
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend renders on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["cornell", "--img", "8", "8", "--disable-ui"])
    assert not list(tmp_path.iterdir())


def test_cli_devices_above_one_raise(tmp_path, monkeypatch):
    """``--devices`` above the card count raises the reference's error; up
    to it the CLI builds a renderer over cards 0 to N - 1 (here, without a
    card, that renderer raises), and with ``--backend cpu`` over N CPU
    replicas (tests/test_torch_parallel.py renders through them)."""
    monkeypatch.chdir(tmp_path)
    argv = ["cornell", "--img", str(SIZE), str(SIZE), "--max-depth",
            str(DEPTH), "--devices", "2", "--disable-ui"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RenderError, match="only 1 devices available"):
        tcli.main(argv)
    made = []

    def stand_in(**kw):  # records the devices and stops before the scene
        made.append(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(tcli, "Renderer", stand_in)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="stop"):
        tcli.main(argv)
    with pytest.raises(RuntimeError, match="stop"):
        tcli.main(BASE + ["--devices", "3", "--disable-ui"])
    assert made == [{"devices": ["cuda:0", "cuda:1"]}, {"devices": ["cpu"] * 3}]
    assert not list(tmp_path.iterdir())


def test_rebuild_watcher_watches_the_cuda_sources(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text("x = 1\n")
    w = relaunch.RebuildWatcher([str(f)], min_interval_s=0.0)
    assert not w.changed()
    os.utime(f, (0, 0))
    assert w.changed()
    names = {os.path.basename(p) for p in relaunch._package_sources()}
    assert {"traverse_resident.cu", "tlas_walk.cuh", "renderer.py"} <= names
    cu = tmp_path / "k.cu"
    cu.write_text("// kernel\n")
    w = relaunch.RebuildWatcher([str(cu)], min_interval_s=0.0)
    assert not w.changed()
    os.utime(cu, (0, 0))
    assert w.changed()
