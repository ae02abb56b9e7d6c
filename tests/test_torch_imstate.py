"""The port's ini state (``app/imstate.py``, ``app/state.py``) against the
JAX package's.

- ``tests/test_imstate.py``'s cases, each run on both packages as a
  parametrised case: on the port, the case's code rebound onto the port's
  modules (``port_case``), so the reference's own assertions are the oracle.
- The ini text both packages write after the same loads and edits is
  byte-equal, and ``AppStateBundle.frame_config()`` is equal field by
  field, through a keyframed replay.
"""

import dataclasses
import importlib
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import test_imstate as ref_cases  # noqa: E402
from realtimepathtracingresearchframework_tpu.app import imstate as jims
from realtimepathtracingresearchframework_tpu.app import state as jstate
from realtimepathtracingresearchframework_tpu_torch.app import imstate as tims
from realtimepathtracingresearchframework_tpu_torch.app import state as tstate

# One torch thread per test process: the tier-1 run has six xdist workers
# on the machine's cores, and torch's OpenMP threads then oversubscribe them
torch.set_num_threads(1)

JAX_PKG = "realtimepathtracingresearchframework_tpu"
PORT_PKG = "realtimepathtracingresearchframework_tpu_torch"


def port_case(module, name, monkeypatch, modules=(), **names):
    """The function ``name`` of the reference test ``module`` rebound onto
    the port: every function of the module is rebuilt over a copy of its
    globals in which ``names`` replace the JAX package's objects, and for
    the call each JAX-package module of ``modules`` (dotted, relative to
    the package) that the code imports inside a function is the port's
    module of the same name. The reference module's own bindings of those
    names raise for the call, so a case that still reached one would fail."""

    def stale(*args, **kwargs):
        raise AssertionError("a port case reached the JAX package's object")

    for key in names:
        monkeypatch.setattr(module, key, stale)
    for rel in modules:
        port_mod = importlib.import_module(f"{PORT_PKG}.{rel}")
        monkeypatch.setitem(sys.modules, f"{JAX_PKG}.{rel}", port_mod)
        parent, _, leaf = f"{JAX_PKG}.{rel}".rpartition(".")
        monkeypatch.setattr(importlib.import_module(parent), leaf, port_mod,
                            raising=False)
    g = dict(vars(module), **names)
    for key, value in list(g.items()):
        if (isinstance(value, types.FunctionType)
                and value.__module__ == module.__name__):
            g[key] = types.FunctionType(value.__code__, g, value.__name__,
                                        value.__defaults__, value.__closure__)
    return g[name]


REF_CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_imstate_case(case, package, tmp_path, monkeypatch):
    fn = getattr(ref_cases, case)
    if package == "torch":
        fn = port_case(ref_cases, case, monkeypatch,
                       modules=("app.imstate", "app.state", "app.cli"),
                       ImState=tims.ImState,
                       AppStateBundle=tstate.AppStateBundle,
                       make_scene_id=tstate.make_scene_id)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


INI = """
[Application][Application Settings]
batch_spp= 2
max_path_depth= 5
variant= PT_WAVEFRONT
[Application][Scene##test/box.vks]
exposure= 0.75
[.][camera]
position= 1.5 2.0 -3.25
fov= 41
..
[.][sun]
direction= 0.3 0.9 0.1
turbidity= 4.5
..

[;][1.0]
[Application][Scene]
[.][Sensor]
Aperture_radius= 0.05
focus_distance= 3.2
..
tonemap_operator= 1

[;][+0.5]
[Application][Application Settings]
render_upscale_factor= 2
reprojection_mode= 2
"""


def _bundles(tmp_path):
    """Both packages' bundles, loaded from the same files."""
    (tmp_path / "inc.ini").write_text(
        "[Application][Application Settings]\nrr_path_depth= 3\n")
    (tmp_path / "main.ini").write_text("[Include][inc.ini]\n" + INI)
    out = []
    for ims_mod, state_mod in ((jims, jstate), (tims, tstate)):
        ims = ims_mod.ImState()
        bundle = state_mod.AppStateBundle(ims, "scenes/test/box.vks")
        ims.load_ini(str(tmp_path / "main.ini"))
        out.append((ims, bundle))
    return out


def _assert_same_config(a, b):
    """Two FrameConfigs equal field by field: camera arrays exactly, params
    and scene config dataclasses field by field."""
    for f in ("pos", "dir", "up"):
        np.testing.assert_array_equal(getattr(a.camera, f), getattr(b.camera, f))
    assert a.camera.fovy == b.camera.fovy
    for x, y in ((a.params, b.params), (a.scene_config, b.scene_config)):
        for f in dataclasses.fields(x):
            assert getattr(x, f.name) == getattr(y, f.name), f.name
        assert [f.name for f in dataclasses.fields(x)] == [
            f.name for f in dataclasses.fields(y)]


def test_ini_text_and_frame_config_match(tmp_path):
    """Base settings, each keyframe of a replay at 0.25 s steps, and widget
    edits: the serialized ini byte-equal and frame_config() field by field
    equal after every step."""
    (jims_, jb), (tims_, tb) = _bundles(tmp_path)
    steps = 0
    for ims in (jims_, tims_):
        ims.apply_base()
    while True:
        assert tims_.serialize() == jims_.serialize()
        _assert_same_config(tb.frame_config(), jb.frame_config())
        t = steps * 0.25
        if jims_.last_keyframe_coming_up(t) and not jims_.have_new_settings(t):
            break
        new = [ims.have_new_settings(t) for ims in (jims_, tims_)]
        assert new[0] == new[1]
        if new[0]:
            for ims in (jims_, tims_):
                ims.handled_new_settings()
        assert tims_.current_keyframe() == jims_.current_keyframe()
        steps += 1
    assert steps == 7 and tims_.num_keyframes() == jims_.num_keyframes() == 3
    for ims in (jims_, tims_):
        assert ims.apply_raw("Scene", ("camera",), "direction", "0 -1 0.5")
        assert ims.apply_raw("Application Settings", (), "pause_rendering", "1")
    assert tims_.describe() == jims_.describe()
    assert tims_.serialize() == jims_.serialize()
    _assert_same_config(tb.frame_config(), jb.frame_config())
    jims_.save_ini(str(tmp_path / "j.ini"))
    tims_.save_ini(str(tmp_path / "t.ini"))
    assert (tmp_path / "j.ini").read_bytes() == (tmp_path / "t.ini").read_bytes()
