"""The reference against the port's CPU path, through the harness's own run
(``run_cell``, which skips only the look for a card), on tiny frames; the
same run with the timed path broken underneath must come out not correct;
the bfloat16 control must fail the comparison; and the benchmark's input
scenes are the port's procedural scenes, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import check, scenes
from perfbench.cells import HERE, load_cell, load_json
from perfbench.program import Program
from perfbench.reference.render import Reference
from perfbench.run import forbidden_modules, run_cell
from perfbench.tests.helpers import DATA, SEARCH, TINY_CELLS, bench_with_tiny_cells
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import Renderer
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.ops import integrator

torch.set_num_threads(1)
SEED = 2**31 + 977


def _cell(name):
    return load_cell(name, bench_with_tiny_cells(), search=SEARCH)


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
def test_sound_run_is_correct(name):
    res = run_cell(_cell(name), SEED, 0.5, False, "cpu")
    assert res["correct"], res["check"]
    assert res["check"]["off_share"]["value"] == 0.0
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}
    assert list(res)[-1] == "check"
    assert not forbidden_modules()


def test_traced_run_reports_the_cell_metrics():
    res = run_cell(_cell("tiny-village"), SEED + 1, 0.3, True, "cpu")
    assert res["correct"], res["check"]
    # no device activity on the CPU: only the readers with something to read
    assert set(res["metrics"]) == {"scene_setup_s", "warmup_s", "frames_traced"}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _break_frame(monkeypatch, frame, fault):
    """Break the frame with sample index ``frame`` where its samples are
    blended into the accumulation."""
    blend = integrator.blend_sample

    def broken(acc, samples, valid, blend_k):
        if blend_k != frame:
            return blend(acc, samples, valid, blend_k)
        if fault == "unchanged":
            return None
        if fault == "half":
            lane = torch.arange(valid.shape[0], device=valid.device)
            return blend(acc, samples, valid & (lane % 2 == 0), blend_k)
        if fault == "altered":
            return blend(acc, tuple(s + 1e-3 for s in samples), valid, blend_k)
        raise ValueError(fault)

    monkeypatch.setattr(integrator, "blend_sample", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_frame_is_not_correct(monkeypatch, fault):
    _break_frame(monkeypatch, 1, fault)
    res = run_cell(_cell("tiny-village"), SEED + 2, 0.5, False, "cpu")
    assert not res["correct"], (fault, res["check"])


def test_skipped_frame_is_not_correct(monkeypatch):
    render = Renderer.render
    calls = []

    def skip_second_window_frame(self, config, *a, **k):
        calls.append(self.frame_id)
        if len(calls) == 3:  # one warm frame, then the window's second
            return self.stats()
        return render(self, config, *a, **k)

    monkeypatch.setattr(Renderer, "render", skip_second_window_frame)
    res = run_cell(_cell("tiny-terrain"), SEED + 3, 0.5, False, "cpu")
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", ["tiny-village", "tiny-terrain"])
def test_bfloat16_control_fails(name):
    cell = _cell(name)
    t, c = cell.traffic, cell.config
    vs = scenes.build(c)
    px, py = check.sample_pixels(SEED, t["width"], t["height"], t["check_pixels"])
    out = {}
    for precision in ("float32", "bfloat16"):
        ref = Reference(vs, c["camera"], c["sun"], t["width"], t["height"],
                        t["max_depth"], t["light_selection"], "cpu",
                        precision=precision)
        out[precision] = ref.pixels(px, py, 4, SEED)
    numbers = check.compare(out["bfloat16"], out["float32"])
    assert not check.judge(numbers, check.limits_for(c)), numbers
    assert numbers["off_share"] > 10.0


def _same(a, b, path):
    """``a`` and ``b`` hold the same fields, values and array bytes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        names = {f.name for f in dataclasses.fields(a)}
        assert names == {f.name for f in dataclasses.fields(b)}, path
        for n in names:
            _same(getattr(a, n), getattr(b, n), f"{path}.{n}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("path", [HERE / "configs" / "village.json",
                                  HERE / "configs" / "terrain500.json",
                                  DATA / "configs" / "tiny-village.json",
                                  DATA / "configs" / "tiny-terrain.json"],
                         ids=lambda p: p.stem)
def test_input_scene_is_the_ports_procedural_scene(path):
    c = load_json(path)
    _same(scenes.build(c), getattr(procedural, c["builder"])(**c["builder_args"]),
          c["builder"])


def test_traffic_sets_render_options():
    cell = _cell("tiny-terrain")
    traffic = dict(cell.traffic, options={"rebuild_triangle_budget": 123456})
    prog = Program(cell.config, traffic, scenes.build(cell.config),
                   device="cpu", log=lambda *a: None)
    assert prog.renderer.options.rebuild_triangle_budget == 123456
    assert prog.spans()["setup_seconds"] > 0


@pytest.mark.cuda
def test_card_run_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run_cell(_cell("tiny-village"), SEED + 4, 1.0, True, "cuda")
    assert res["correct"], res["check"]
    assert res["device"]["busy_s"] > 0
    assert np.isfinite(res["metrics"]["kernels_per_frame"]["value"])
