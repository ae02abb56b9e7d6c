"""The port's resident traversal (K1) against the JAX package's.

The plain PyTorch version of K1 (``ops/traverse.py``, what the wrapper in
``ops/traverse_resident.py`` runs on CPU tensors) is held against the
reference kernel ``traverse_pallas2.closest_hit_pallas2`` /
``occluded_pallas2`` run in Pallas interpret mode, on the fixture of
tests/test_traverse_kernels.py. Hit triangles and blocked flags must be
exact. t, u and v agree to 1e-5 relative (u and v, which lie in [0, 1],
to 1e-5 absolute): both evaluate Möller-Trumbore in the same expression
order, but XLA contracts some of the multiply-adds into FMAs and the port
does not, so the last bits differ (as test_traverse_kernels.py:11-17 notes
for its own kernels).

The CUDA kernel itself is compared with this plain version bitwise on the
card, by ``chip_smoke.py`` and by the ``cuda``-marked test below.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.models import procedural
from realtimepathtracingresearchframework_tpu.models.scene import Scene
from realtimepathtracingresearchframework_tpu.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas2 as tp2
from realtimepathtracingresearchframework_tpu_torch.kernels import build
from realtimepathtracingresearchframework_tpu_torch.ops import intersect
from realtimepathtracingresearchframework_tpu_torch.ops import traverse
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident as tr
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_traverse_kernels import _rays, _terrain  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py


@pytest.fixture(autouse=True)
def _interpret_kernels():
    tp2.INTERPRET = True
    yield
    tp2.INTERPRET = False


def _cornell():
    flat = Scene.from_vkr_scene(procedural.cornell_box()).flatten_world()
    return flat.v0, flat.e1, flat.e2


def _cornell_rays(n, rng, kind):
    if kind == "coherent":
        side = int(np.sqrt(n))
        u = np.linspace(-0.6, 0.6, side, dtype=np.float32)
        uu, vv = np.meshgrid(u, u)
        d = np.stack([uu.ravel(), vv.ravel(), -np.ones(side * side)], -1)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        ro = np.broadcast_to(np.float32([0.0, 1.0, 3.2]), d.shape).copy()
        return ro[:n], d[:n]
    ro = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return ro, d / np.linalg.norm(d, axis=-1, keepdims=True)


SCENES = {"terrain24": (_terrain, _rays), "cornell": (lambda _: _cornell(), _cornell_rays)}


def _soa(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(), t[:, 2].contiguous())


def _build(scene, leaf_size):
    v0, e1, e2 = SCENES[scene][0](24)
    return bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=leaf_size)


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
@pytest.mark.parametrize("leaf_size", [32, 64, 128])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_k1_matches_pallas_interpret(rng, scene, leaf_size, kind):
    tb = _build(scene, leaf_size)
    bb = tp2.pack_for_pallas2(tb)
    bvh = tr.pack_resident(tb)
    ro, rd = SCENES[scene][1](1024, rng, kind)

    ref = tp2.closest_hit_pallas2(bb, jnp.asarray(ro), jnp.asarray(rd))
    hit = traverse.map_rows_to_tris(
        bvh, tr.closest_hit_resident(bvh, _soa(ro), _soa(rd))
    )
    tri_ref = np.asarray(ref.tri)
    np.testing.assert_array_equal(hit.tri.numpy(), tri_ref)
    assert 0.05 < (tri_ref >= 0).mean()
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=0)
    for port, want in ((hit.u, ref.u), (hit.v, ref.v)):
        np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    # occlusion with tight segments: just short of the hit (never blocked
    # by it) and just past it (always blocked), as test_traverse_kernels
    t_ref = np.asarray(ref.t)
    for scale in (0.999, 1.001):
        tmax = np.where(tri_ref >= 0, t_ref * scale, 1e30).astype(np.float32)
        o_ref = np.asarray(
            tp2.occluded_pallas2(bb, jnp.asarray(ro), jnp.asarray(rd),
                                 t_max=jnp.asarray(tmax))
        )
        o_port = tr.occluded_resident(
            bvh, _soa(ro), _soa(rd), t_max=torch.from_numpy(tmax)
        )
        np.testing.assert_array_equal(o_port.numpy(), o_ref)
        if scale > 1.0:
            assert o_ref[tri_ref >= 0].all()


@pytest.mark.parametrize("leaf_size", [4, 32, 128])
def test_plain_k1_matches_brute_force(rng, leaf_size):
    """Closest hit equals the brute-force minimum over every triangle
    (intersect.ray_tri), whatever the leaf size and the tree shape."""
    v0, e1, e2 = _terrain(16)
    tb = bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=leaf_size)
    ro, rd = _rays(512, rng, "incoherent")
    bvh = tr.pack_resident(tb)
    hit = traverse.map_rows_to_tris(
        bvh, tr.closest_hit_resident(bvh, _soa(ro), _soa(rd))
    )
    ok, t, _, _ = intersect.ray_tri(
        torch.from_numpy(ro)[:, None], torch.from_numpy(rd)[:, None],
        torch.from_numpy(v0)[None], torch.from_numpy(e1)[None],
        torch.from_numpy(e2)[None], 0.0, intersect.T_MAX,
    )
    t = torch.where(ok, t, intersect.T_MAX)
    t_min, tri = t.min(dim=1)
    tri = torch.where(t_min < intersect.T_MAX, tri, -1)
    np.testing.assert_array_equal(hit.tri.numpy(), tri.numpy())
    np.testing.assert_allclose(hit.t.numpy(), t_min.numpy(), rtol=1e-5)


def test_empty_segments_and_tmin_window(rng):
    """tmax <= tmin walks nothing (miss / unblocked); a tmin past the
    closest hit finds the next surface or nothing."""
    tb = _build("terrain24", 32)
    bvh = tr.pack_resident(tb)
    ro, rd = _rays(256, rng, "coherent")
    o, d = _soa(ro), _soa(rd)
    dead = tr.closest_hit_resident(bvh, o, d, t_min=1.0, t_max=1.0)
    assert (dead.tri == -1).all() and (dead.t == intersect.T_MAX).all()
    assert not tr.occluded_resident(bvh, o, d, t_min=2.0, t_max=0.0).any()
    first = tr.closest_hit_resident(bvh, o, d)
    beyond = tr.closest_hit_resident(bvh, o, d, t_min=first.t * 1.0001)
    hit = first.tri >= 0
    assert (beyond.t[hit] > first.t[hit]).all()


def test_pack_resident_links_are_int32(rng):
    """Node links stay int32 tensors: skip index and leaf index, matching
    the reference's v2 pack (which stores them as float values)."""
    tb = _build("terrain24", 64)
    bvh = tr.pack_resident(tb)
    bb = tp2.pack_for_pallas2(tb)
    assert bvh.links.dtype == torch.int32 and bvh.leaf_size == 64
    nodes = np.asarray(bb.nodes)
    np.testing.assert_array_equal(bvh.links.numpy(), nodes[:, 6:8].astype(np.int32))
    np.testing.assert_array_equal(bvh.bounds.numpy(), nodes[:, 0:6])
    np.testing.assert_array_equal(bvh.tri_rows.numpy(), tb.tri_rows[:, 0:9])


def test_kernel_module_imports_without_toolchain():
    """The wrapper module imports (and the CPU path runs) with no nvcc,
    no triton and no card; only a CUDA tensor reaches the build."""
    assert tr.KERNEL == "traverse_resident"
    assert tr.launches >= 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("traverse_resident")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("traverse_resident")
    assert not list(tmp_path.iterdir())


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng):
    """K1 on the card equals its plain version bitwise (also run by
    chip_smoke.py at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    tb = _build("terrain24", 32)
    bvh = tr.pack_resident(tb, "cuda")
    ro, rd = _rays(4096, rng, "incoherent")
    o = Vec3(*(c.cuda() for c in _soa(ro)))
    d = Vec3(*(c.cuda() for c in _soa(rd)))
    before = tr.launches
    hk = tr.closest_hit_resident(bvh, o, d)
    hp = traverse.closest_hit_threaded(bvh, o, d)
    assert tr.launches == before + 1
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    tmax = torch.where(hk.tri >= 0, hk.t * 1.001, 1e30)
    assert torch.equal(tr.occluded_resident(bvh, o, d, t_max=tmax),
                       traverse.occluded_threaded(bvh, o, d, t_max=tmax))
