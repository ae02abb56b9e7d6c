"""LoD re-selection and hot reload of the port on the CPU.

- ``test_lod_selection_drives_renderer`` and ``test_lod_with_animation_refit``
  (the reference's tests/test_animation.py:108 and :211) on the port and on
  the JAX renderer side by side: the triangles each frame's flatten
  selects, that a stable selection keeps the flattened scene (no rebuild),
  the rebuild count, and closest-hit queries equal to the JAX renderer's
  (source triangle and t) after each change of selection and animation
  frame; an animation frame that changes the selection itself rebuilds
  instead of refitting.
- ``hot_reload`` in a subprocess on a copy of the package (the pytest
  worker never reloads a module): the first call records the modules'
  sources, an edited ``ops/taa.py`` reloads it and every module after it
  (``ops/integrator.py`` last), the renderer's imported names are rebound
  to the new objects, the loaded kernel libraries are dropped, and the
  next frame is bitwise the one before the reload.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu.backend import renderer as jrend
from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams as JParams,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models import vkr as jvkr
from realtimepathtracingresearchframework_tpu.models.camera import (
    OrientedCamera as JCam,
)
from realtimepathtracingresearchframework_tpu.models.quantization import (
    quantize_transforms as jquant,
)
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JScene
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models import vkr
from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu_torch.models.quantization import (
    quantize_transforms,
)
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene

torch.set_num_threads(1)  # see tests/test_torch_render.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "realtimepathtracingresearchframework_tpu_torch"
FINE = np.array([
    [[-1, -1, 0], [0, -1, 0], [-0.5, 0, 0]],
    [[0, -1, 0], [1, -1, 0], [0.5, 0, 0]],
    [[-0.5, 0, 0], [0.5, 0, 0], [0, 1, 0]],
    [[-0.5, 0, 0], [0, -1, 0], [0.5, 0, 0]],
], np.float32)
COARSE = np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)


def _lod_scene(proc, vk):
    """tests/test_animation.py:131-153: one mesh of 4 triangles in LoD
    group 1 with a 1-triangle coarse level."""
    vs = proc.identity_scene(
        [proc.make_mesh("fine", FINE)],
        [vk.VkrMaterial(name="m", base_color=np.ones(3, np.float32))])
    coarse = proc.make_mesh("fine_lod1", COARSE)
    coarse.lod_group = 1
    vs.meshes[0].lod_group = 1
    vs.meshes.append(coarse)
    vs.lod_groups.append(vk.VkrLodGroup(mesh_ids=[0, 1],
                                        detail_reduction=[0.0, 0.5]))
    return vs


def _animated_lod_scene(proc, vk, quant):
    """tests/test_animation.py:227-268: the LoD mesh beside an animated
    triangle riding x = 4 + frame, 3 frames."""
    fine = proc.make_mesh("fine", FINE)
    fine.lod_group = 1
    coarse = proc.make_mesh("fine_lod1", COARSE)
    coarse.lod_group = 1
    anim = proc.make_mesh("anim", COARSE)
    ident = np.zeros((3, 4), np.float32)
    ident[:, :3] = np.eye(3)
    mats = []
    for f in range(3):
        m = ident.copy()
        m[0, 3] = 4.0 + f
        mats.append(m)
    return vk.VkrScene(
        materials=[vk.VkrMaterial(name="m", base_color=np.ones(3, np.float32))],
        meshes=[fine, coarse, anim],
        instances=[vk.VkrInstance(name="fine", mesh_id=0, transform_index=0),
                   vk.VkrInstance(name="anim", mesh_id=2, transform_index=1)],
        lod_groups=[vk.VkrLodGroup(),
                    vk.VkrLodGroup(mesh_ids=[0, 1], detail_reduction=[0.0, 0.5])],
        num_static_transforms=1, num_animated_transforms=1, num_frames=3,
        transforms_q=quant(np.stack([ident] + mats)),
    )


def _pair(vs_port, vs_jax, size=8, budget=None):
    r = trend.Renderer(device="cpu")
    jr = jrend.Renderer()
    for x in (r, jr):
        x.initialize(size, size)
        if budget is not None:
            x.options = x.options.replace(rebuild_triangle_budget=budget)
    r.set_scene(Scene.from_vkr_scene(vs_port))
    jr.set_scene(JScene.from_vkr_scene(vs_jax))
    return r, jr


def _queries():
    xs = np.linspace(-1.2, 6.8, 17, dtype=np.float32)
    ys = np.linspace(-1.1, 1.1, 9, dtype=np.float32)
    o = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    o = np.concatenate([o, np.full((len(o), 1), 5.0, np.float32)], 1)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (len(o), 1))
    return o, d


def _same_hits(r, jr):
    """The port's closest hits equal the JAX renderer's: the source
    triangle of every query and t within 1e-6 relative."""
    o, d = _queries()
    t, tri, _, _ = r.render_ray_queries(o, d)
    jt, jtri, _, _ = jr.render_ray_queries(o, d)
    np.testing.assert_array_equal(tri, np.asarray(jtri))
    hit = tri >= 0
    np.testing.assert_allclose(t[hit], np.asarray(jt)[hit], rtol=1e-6)
    return int(hit.sum())


def _render(r, jr, eye, depth):
    at = [0, 0, 0]
    r.render(trend.FrameConfig(camera=OrientedCamera.look_at(eye, at, fovy=50),
                               params=RenderParams(max_path_depth=depth)))
    jr.render(jrend.FrameConfig(camera=JCam.look_at(eye, at, fovy=50),
                                params=JParams(max_path_depth=depth)))


def test_lod_selection_drives_renderer():
    """The render path re-flattens when the camera's LoD selection changes
    and leaves the geometry alone while it is stable, as the reference's
    renderer does, with the same selections and hits."""
    r, jr = _pair(_lod_scene(procedural, vkr), _lod_scene(jproc, jvkr))
    assert r.scene.has_lod_groups() and r._lod_signature == jr._lod_signature
    near, far = [0, 0, 3.0], [0, 0, 4e4]
    _render(r, jr, near, 1)
    assert r._flat.num_tris == jr._flat.num_tris == 4
    flat_near = r._flat
    _render(r, jr, near, 1)
    assert r._flat is flat_near and r.lod_rebuilds == 0
    assert _same_hits(r, jr) > 0
    _render(r, jr, far, 1)
    assert r._flat.num_tris == jr._flat.num_tris == 1
    assert r._lod_signature == jr._lod_signature and r.lod_rebuilds == 1
    assert r.frame_id == jr.frame_id == 1  # the rebuild restarted it
    assert _same_hits(r, jr) > 0
    _render(r, jr, near, 1)
    assert r._flat.num_tris == jr._flat.num_tris == 4 and r.lod_rebuilds == 2
    assert _same_hits(r, jr) > 0


def test_lod_with_animation_refit():
    """set_animation_frame on an LoD scene flattens with the selection the
    topology was built over (the coarse level the far camera chose), and
    refits; the hits follow the animated triangle as the reference's."""
    r, jr = _pair(_animated_lod_scene(procedural, vkr, quantize_transforms),
                  _animated_lod_scene(jproc, jvkr, jquant), budget=0)
    _render(r, jr, [0, 0, 60.0], 2)
    assert r._flat.num_tris == jr._flat.num_tris == 2  # coarse + animated
    assert r.lod_rebuilds == 1
    r.set_animation_frame(2)
    jr.set_animation_frame(2)
    assert r._flat.num_tris == jr._flat.num_tris == 2
    assert r._scene_frame == jr._scene_frame == 2
    assert r.animation_update == "refit" and r.lod_rebuilds == 1
    assert _same_hits(r, jr) > 0
    o, d = np.array([[6.0, -0.5, 5.0], [4.0, -0.5, 5.0]], np.float32), \
        np.array([[0.0, 0.0, -1.0]] * 2, np.float32)
    _, tri, _, _ = r.render_ray_queries(o, d)
    assert tri[0] >= 0 and tri[1] == -1
    # the configure_for rebuild keeps the LoD camera's selection
    r.configure_for(r.options.replace(quantized_geometry=True))
    jr.configure_for(jr.options.replace(quantized_geometry=True))
    assert r._flat.num_tris == jr._flat.num_tris == 2
    assert _same_hits(r, jr) > 0


def _riding_lod_scene(proc, vk, quant):
    """The LoD mesh on an animated transform: at the origin in frames 0
    and 1, at z = 57 in frame 2."""
    fine = proc.make_mesh("fine", FINE)
    fine.lod_group = 1
    coarse = proc.make_mesh("fine_lod1", COARSE)
    coarse.lod_group = 1
    mats = np.zeros((4, 3, 4), np.float32)
    mats[:, :, :3] = np.eye(3)
    mats[3, 2, 3] = 57.0
    return vk.VkrScene(
        materials=[vk.VkrMaterial(name="m", base_color=np.ones(3, np.float32))],
        meshes=[fine, coarse],
        instances=[vk.VkrInstance(name="fine", mesh_id=0, transform_index=1)],
        lod_groups=[vk.VkrLodGroup(),
                    vk.VkrLodGroup(mesh_ids=[0, 1], detail_reduction=[0.0, 0.5])],
        num_static_transforms=1, num_animated_transforms=1, num_frames=3,
        transforms_q=quant(mats),
    )


def test_animation_frame_that_changes_the_selection_rebuilds():
    """A frame that moves an LoD instance across its distance band changes
    the selection the topology was built over: the scene is rebuilt at the
    new selection (``lod_rebuilds``) instead of refit, as the reference's
    renderer does; a frame that keeps it refits."""
    r, jr = _pair(_riding_lod_scene(procedural, vkr, quantize_transforms),
                  _riding_lod_scene(jproc, jvkr, jquant), budget=0)
    _render(r, jr, [0, 0, 60.0], 1)  # far: the coarse level, camera kept
    assert r._flat.num_tris == jr._flat.num_tris == 1 and r.lod_rebuilds == 1
    r.set_animation_frame(1)
    jr.set_animation_frame(1)
    assert r.animation_update == "refit" and r.lod_rebuilds == 1
    r.set_animation_frame(2)  # 3 from the camera: the fine level
    jr.set_animation_frame(2)
    assert r.animation_update == "rebuild" and r.lod_rebuilds == 2
    assert r._lod_signature == jr._lod_signature
    assert r._flat.num_tris == jr._flat.num_tris == 4
    assert r._scene_frame == jr._scene_frame == 2 and r.frame_id == 0


HOT_RELOAD_SCRIPT = textwrap.dedent('''
    import os, sys, time
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pkg = "realtimepathtracingresearchframework_tpu_torch"
    from realtimepathtracingresearchframework_tpu_torch.backend import renderer as rend
    from realtimepathtracingresearchframework_tpu_torch.backend.params import RenderParams
    from realtimepathtracingresearchframework_tpu_torch.kernels import build
    from realtimepathtracingresearchframework_tpu_torch.models import procedural
    from realtimepathtracingresearchframework_tpu_torch.models.camera import OrientedCamera
    from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
    from realtimepathtracingresearchframework_tpu_torch.ops import integrator, taa, vec3
    assert rend.__file__.startswith(os.getcwd()), rend.__file__

    r = rend.Renderer(device="cpu")
    r.options = r.options.replace(enable_taa=True)
    r.initialize(16, 16)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    cfg = rend.FrameConfig(
        camera=OrientedCamera.look_at([0, 1, 3.2], [0, 1, 0], fovy=50),
        params=RenderParams(max_path_depth=2, render_upscale_factor=2))

    def frame():
        r.frame_id = 0
        r.render(cfg)
        return r.readback_framebuffer()

    before = frame()
    assert r.hot_reload() is False  # records the sources
    old_integrator_fn = integrator.make_pass_fn
    old_vec3 = vec3.Vec3
    build._loaded["probe"] = object()
    path = taa.__file__
    with open(path, "a") as f:
        f.write("\\nHOT_RELOAD_PROBE = 1\\n")
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 5))
    assert r.hot_reload() is True
    mods = sys.modules
    assert getattr(mods[pkg + ".ops.taa"], "HOT_RELOAD_PROBE") == 1
    assert mods[pkg + ".ops.integrator"].make_pass_fn is not old_integrator_fn
    assert rend.make_pass_fn is mods[pkg + ".ops.integrator"].make_pass_fn
    assert rend.render_tile_host is mods[pkg + ".ops.integrator"].render_tile_host
    assert mods[pkg + ".ops.vec3"].Vec3 is old_vec3  # upstream: kept
    assert build._loaded == {}
    after = frame()
    assert after.tobytes() == before.tobytes()
    assert r.hot_reload() is False  # nothing edited since
    print("HOT_RELOAD_OK")
''')


def test_hot_reload_in_a_subprocess(tmp_path):
    """``Renderer.hot_reload`` on a copy of the package, in a fresh
    interpreter without the JAX package on its path."""
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(tmp_path, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    out = subprocess.run([sys.executable, "-c", HOT_RELOAD_SCRIPT],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "HOT_RELOAD_OK" in out.stdout
