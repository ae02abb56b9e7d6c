"""The port's own copies of the JAX package's host modules (scene
flattening, BVH build, sky cook, ...) give the same arrays as the
originals, so the port can stop importing the JAX package without changing
a single input of its kernels.
"""

import dataclasses

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models import sky_hosek as jhosek
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JScene
from realtimepathtracingresearchframework_tpu.ops import bvh as jbvh
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models import sky_hosek as thosek
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene as TScene
from realtimepathtracingresearchframework_tpu_torch.ops import bvh as tbvh

SCENES = {
    "cornell": lambda m: m.cornell_box(),
    "terrain24": lambda m: m.terrain(grid=24),
    "village20": lambda m: m.village(grid=20),
    "instanced40": lambda m: m.instanced_field(num_inst=40, frames=4),
}


def _flat(mod, scene_cls, name):
    return scene_cls.from_vkr_scene(SCENES[name](mod)).flatten_world()


def _assert_same(a, b, path="."):
    """Equal arrays (bitwise), recursively through dataclasses and tuples."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype, path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", sorted(SCENES))
def test_flatten_world_matches(name):
    ref = _flat(jproc, JScene, name)
    port = _flat(tproc, TScene, name)
    assert port.num_tris == ref.num_tris > 0
    _assert_same(port, ref)


def test_flatten_world_matches_at_an_animation_frame():
    """The flattened instanced field at animation frame 3 (the animated
    flattened route re-flattens every frame)."""
    ref = JScene.from_vkr_scene(SCENES["instanced40"](jproc)).flatten_world(frame=3)
    port = TScene.from_vkr_scene(SCENES["instanced40"](tproc)).flatten_world(frame=3)
    _assert_same(port, ref)
    assert not np.array_equal(port.v0, _flat(tproc, TScene, "instanced40").v0)


@pytest.mark.parametrize("leaf_size", [32, 128])
def test_bvh_build_matches(leaf_size):
    """build_bvh_sah + thread_bvh on terrain(24): nodes, rows and row ids."""
    flat = _flat(jproc, JScene, "terrain24")
    args = (flat.v0, flat.e1, flat.e2)
    ref = jbvh.thread_bvh(jbvh.build_bvh_sah(*args, leaf_size=leaf_size), *args)
    port = tbvh.thread_bvh(tbvh.build_bvh_sah(*args, leaf_size=leaf_size), *args)
    for field in ("nodes", "tri_rows", "row_tri"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field))
    assert port.leaf_size == ref.leaf_size == leaf_size


@pytest.mark.parametrize("turbidity,sun", [(3.0, (0.4, 0.7, 0.2)),
                                           (6.0, (0.3, 0.2, -0.5))])
def test_hosek_cook_matches(turbidity, sun):
    """The port's copy finds its own data file (so the sky is Hosek, not
    the Preetham fallback) and cooks the same state and sun disc."""
    assert thosek.hosek_data_available()
    d = np.asarray(sun, np.float64)
    d /= np.linalg.norm(d)
    elev = float(np.arcsin(d[1]))
    ref = jhosek.rgb_state(turbidity, 0.1, elev)
    port = thosek.rgb_state(turbidity, 0.1, elev)
    _assert_same(port, ref)
    port_sun = thosek.sun_disc_radiance_rgb(float(d[1]), turbidity, 0.1)
    ref_sun = jhosek.sun_disc_radiance_rgb(float(d[1]), turbidity, 0.1)
    assert ref_sun is not None
    np.testing.assert_array_equal(port_sun, ref_sun)


def test_pointset_tables_are_a_byte_copy():
    """The port's data/pointset_tables.npz is the JAX package's, byte for
    byte, and the port reads the same arrays from it."""
    import os

    from realtimepathtracingresearchframework_tpu.ops import (
        pointsets_tables as jptab,
    )
    from realtimepathtracingresearchframework_tpu_torch.ops import (
        pointsets_tables as tptab,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, pkg, "data", "pointset_tables.npz") for pkg in (
        "realtimepathtracingresearchframework_tpu",
        "realtimepathtracingresearchframework_tpu_torch")]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert tptab.tables_available()
    port, ref = tptab._tables_np(), jptab._tables_np()
    assert sorted(port.files) == sorted(ref.files)
    for name in ref.files:
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)


def test_sobol_matrices_match():
    """The port's copy of the self-generated Sobol matrices (the primitive
    polynomial search and the seeded initial direction numbers)."""
    from realtimepathtracingresearchframework_tpu.ops import sobol as jsobol
    from realtimepathtracingresearchframework_tpu_torch.ops import sobol as tsobol

    assert tsobol._primitive_polys(127) == jsobol._primitive_polys(127)
    port, ref = tsobol.sobol_matrices(), jsobol.sobol_matrices()
    assert port.dtype == ref.dtype == np.uint32 and port.shape == (128, 32)
    np.testing.assert_array_equal(port, ref)


def test_halton_matches():
    """The port's copy of the Halton(2,3) table: the radical inverse, the
    table and the centred jitter, equal to the reference's."""
    from realtimepathtracingresearchframework_tpu.utils import halton as jh
    from realtimepathtracingresearchframework_tpu_torch.utils import halton as th

    for i in (0, 1, 2, 7, 63, 64, 1000):
        for base in (2, 3, 5):
            assert th.radical_inverse(i, base) == jh.radical_inverse(i, base)
    for n in (8, 64):
        np.testing.assert_array_equal(th.halton_23(n), jh.halton_23(n))
    for f in (0, 1, 63, 64, 65, 1000):
        np.testing.assert_array_equal(th.halton_jitter(f), jh.halton_jitter(f))


def _renamed(path):
    """A module's source with the port's package name written as the JAX
    package's."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, path)) as f:
        return f.read().replace("realtimepathtracingresearchframework_tpu_torch",
                                "realtimepathtracingresearchframework_tpu")


@pytest.mark.parametrize("rel", ["app/imstate.py", "app/benchmark.py",
                                 "app/state.py"])
def test_app_copies_are_the_reference_renamed(rel):
    """The app shell's pure-numpy modules are the reference's, only the
    package name differs (imports of the port's own error_io, online_stats,
    params, renderer and camera)."""
    port = _renamed(f"realtimepathtracingresearchframework_tpu_torch/{rel}")
    ref = _renamed(f"realtimepathtracingresearchframework_tpu/{rel}")
    assert port == ref


def test_relaunch_watcher_logic_matches():
    """``app/relaunch.py``'s watcher and relaunch are the reference's; the
    one difference is what it watches: the reference's ``.py`` files, the
    port's ``.py`` files and its CUDA sources (``SOURCE_SUFFIXES``), whose
    edit rebuilds a kernel on relaunch."""
    import inspect

    from realtimepathtracingresearchframework_tpu.app import relaunch as jrel
    from realtimepathtracingresearchframework_tpu_torch.app import relaunch as trel

    for name in ("RebuildWatcher", "relaunch"):
        assert inspect.getsource(getattr(trel, name)) == inspect.getsource(
            getattr(jrel, name))
    port = inspect.getsource(trel._package_sources).replace(
        "_torch as pkg", " as pkg").replace(
        "f.endswith(SOURCE_SUFFIXES)", 'f.endswith(".py")')
    assert port == inspect.getsource(jrel._package_sources)
    assert trel.SOURCE_SUFFIXES == (".py", ".cu", ".cuh")


def test_benchmark_csv_matches(tmp_path):
    """BenchmarkInfo over OnlineStats: the same CSV bytes and statistics
    from the same frames and extension columns."""
    from realtimepathtracingresearchframework_tpu.app import benchmark as jb
    from realtimepathtracingresearchframework_tpu_torch.app import benchmark as tb

    class Source:
        def __init__(self):
            self.n = 0

        def csv_header(self):
            return ["x_ms", "y_ms"]

        def csv_values(self):
            self.n += 1
            return [self.n * 0.5, 1.0 / self.n]

    rng = np.random.default_rng(2)
    times = rng.random((9, 2)) * 20
    out = []
    for tag, mod in (("j", jb), ("t", tb)):
        bi = mod.BenchmarkInfo()
        bi.register_source(Source())
        bi.open_csv(str(tmp_path / f"{tag}.csv"))
        for k, (r, a) in enumerate(times):
            bi.aggregate_frame(float(r), float(a))
            bi.write_csv(k // 3, k % 3 + 1, float(r), float(a))
        bi.close_csv()
        out.append((bi.p50_render_time(), bi.render_time_stats.mean,
                    bi.app_time_stats.variance, bi.frames_total))
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
    assert out[0] == out[1]
