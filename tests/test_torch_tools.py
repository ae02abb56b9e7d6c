"""The port's CLI tools (``tools/*``) against the JAX package's.

- ``tests/test_tools.py``'s and ``tests/test_tools_exporters.py``'s cases
  run on the port (``test_torch_imstate.port_case``), except
  ``test_precompile_tool`` (``tools/precompile.py``, the XLA cache
  lattice, is not ported).
- Byte-equal outputs on the same inputs: ``vkr2obj``'s ``.obj`` text,
  ``vktconvert``'s ``.vkt`` bytes, ``vktinfo``'s stdout, ``prepare_sobol``'s
  Joe-Kuo source text and generated ``.npz`` arrays, and the Blender
  core's ``.vks``, camera-path ini and PBR ``.vkt`` files.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import test_tools as ref_tools  # noqa: E402
import test_tools_exporters as ref_exporters  # noqa: E402
from test_torch_imstate import port_case  # noqa: E402
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models import vkr as jvkr
from realtimepathtracingresearchframework_tpu.ops import pointsets_tables as jptab
from realtimepathtracingresearchframework_tpu.tools import blender_vkr as jblender
from realtimepathtracingresearchframework_tpu.tools import prepare_sobol as jsobol
from realtimepathtracingresearchframework_tpu.tools import vkr2obj as jvkr2obj
from realtimepathtracingresearchframework_tpu.tools import vktconvert as jvktconvert
from realtimepathtracingresearchframework_tpu.tools import vktinfo as jvktinfo
from realtimepathtracingresearchframework_tpu_torch.models import procedural as tproc
from realtimepathtracingresearchframework_tpu_torch.models import texture as ttexture
from realtimepathtracingresearchframework_tpu_torch.models import vkr as tvkr
from realtimepathtracingresearchframework_tpu_torch.tools import blender_vkr as tblender
from realtimepathtracingresearchframework_tpu_torch.tools import prepare_sobol as tsobol
from realtimepathtracingresearchframework_tpu_torch.tools import vkr2obj as tvkr2obj
from realtimepathtracingresearchframework_tpu_torch.tools import vktconvert as tvktconvert
from realtimepathtracingresearchframework_tpu_torch.tools import vktinfo as tvktinfo
from realtimepathtracingresearchframework_tpu_torch.utils.image_io import write_png

# One torch thread per test process: the tier-1 run has six xdist workers
# on the machine's cores, and torch's OpenMP threads then oversubscribe them
torch.set_num_threads(1)

PORT_NAMES = dict(
    blender_vkr=tblender, vkr2obj=tvkr2obj, vktconvert=tvktconvert,
    vktinfo=tvktinfo, procedural=tproc, texture=ttexture, vkr=tvkr,
    write_png=write_png, B=tblender)
REF = [(ref_tools, n) for n in sorted(vars(ref_tools))
       if n.startswith("test_") and n != "test_precompile_tool"]
REF += [(ref_exporters, n) for n in sorted(vars(ref_exporters))
        if n.startswith("test_")]


@pytest.mark.parametrize("module,case", REF, ids=[c for _, c in REF])
def test_reference_tools_case_on_port(module, case, tmp_path, monkeypatch,
                                      request):
    names = {k: v for k, v in PORT_NAMES.items() if k in vars(module)}
    fn = port_case(module, case, monkeypatch,
                   modules=("app.imstate", "app.state", "models.texture",
                            "ops.pointsets_tables", "tools.prepare_sobol"),
                   **names)
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fn(*(request.getfixturevalue(a) if a != "tmp_path" else tmp_path
         for a in args))


def test_vkr2obj_text_matches(tmp_path):
    for name, scene in (("cornell", jproc.cornell_box()),
                        ("village", jproc.village(grid=6))):
        vks = str(tmp_path / f"{name}.vks")
        jvkr.write_scene(vks, scene)
        outs = []
        for tag, mod in (("j", jvkr2obj), ("t", tvkr2obj)):
            out = tmp_path / f"{name}_{tag}.obj"
            assert mod.main([vks, str(out)]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1] and outs[0].count(b"\nf ") > 0


@pytest.mark.parametrize("shape", [(10, 12, 3), (16, 8, 4), (5, 7, 3)])
def test_vktconvert_and_vktinfo_match(tmp_path, capsys, shape):
    png = str(tmp_path / "in.png")
    write_png(png, (np.random.default_rng(3).random(shape) * 255).astype(np.uint8))
    outs, infos = [], []
    for tag, conv, info in (("j", jvktconvert, jvktinfo),
                            ("t", tvktconvert, tvktinfo)):
        out = tmp_path / f"{tag}.vkt"
        assert conv.main([png, str(out)]) == 0
        capsys.readouterr()
        outs.append(out.read_bytes())
        assert info.main([str(out)]) == 0
        infos.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert infos[0] == infos[1] and "mip[0]" in infos[0]


def test_prepare_sobol_matches(tmp_path, capsys):
    """The Joe-Kuo source of the shipped table's first 40 dimensions,
    written as text by both, then ``main --from-source`` of each: the same
    stdout and the same generated matrices and inversion tile."""
    mats = np.asarray(jptab._tables_np()["sobol_matrix"], np.uint32)[:40]
    src_j, src_t = jsobol.extract_source(mats), tsobol.extract_source(mats)
    assert src_j == src_t
    jsobol.write_joe_kuo_file(src_j, str(tmp_path / "j.txt"))
    tsobol.write_joe_kuo_file(src_t, str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    results = []
    for tag, mod in (("j", jsobol), ("t", tsobol)):
        npz = str(tmp_path / f"{tag}.npz")
        assert mod.main(["--from-source", str(tmp_path / "j.txt"),
                         "--tile-size", "64", "--npz", npz]) == 0
        out = capsys.readouterr().out.replace(npz, "<npz>")
        with np.load(npz) as z:
            results.append((out, {k: z[k] for k in z.files}))
    assert results[0][0] == results[1][0]
    j, t = results[0][1], results[1][1]
    assert sorted(j) == sorted(t) == ["sobol_invert", "sobol_matrix"]
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype


def test_blender_core_exports_match(tmp_path):
    rng = np.random.default_rng(5)
    tris = rng.random((6, 3, 3)).astype(np.float32)
    ident = np.zeros((3, 4), np.float32)
    ident[:, :3] = np.eye(3)
    moved = ident.copy()
    moved[:, 3] = [1.0, 0.5, -2.0]
    meshes = [{"name": "m", "triangles": tris,
               "material_ids": np.array([0, 1, 0, 1, 1, 0])}]
    instances = [{"name": "a", "mesh_id": 0, "transform": ident},
                 {"name": "b", "mesh_id": 0, "transform": moved}]
    materials = [{"name": "Mat", "base_color": (0.5, 0.2, 0.1), "emission": 0.0},
                 {"name": "Light", "emission": 4.0,
                  "emission_color": (1.0, 0.9, 0.8), "transmission": 0.5,
                  "ior": 1.4}]
    cam = np.eye(4)
    cam[:3, 3] = [1.0, 2.0, 3.0]
    frames = [jblender.blender_matrix_to_camera(cam)] * 2
    layers = {"Wood/Var:1": {"BaseColor": rng.random((8, 8, 4)).astype(np.float32),
                             "Normal": np.full((8, 8, 4), 0.5, np.float32)}}
    written = {}
    for tag, mod in (("j", jblender), ("t", tblender)):
        d = tmp_path / tag
        d.mkdir()
        mod.export_scene_data(meshes, instances, materials, str(d / "s.vks"))
        for r, t in zip(mod.blender_matrix_to_camera(cam), frames[0]):
            np.testing.assert_array_equal(r, t)
        mod.export_camera_path_ini(frames, str(d / "path.ini"),
                                   seconds_per_frame=0.5)
        paths = mod.export_pbr_textures(layers, str(d / "tex"))
        written[tag] = {p.relative_to(d): p.read_bytes()
                        for p in sorted(d.rglob("*")) if p.is_file()}
        assert len(paths) == 2
    assert sorted(written["j"]) == sorted(written["t"])
    for k, v in written["j"].items():
        assert written["t"][k] == v, k
