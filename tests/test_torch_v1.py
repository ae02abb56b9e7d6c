"""The v1 packet walk (K8a, K8b) and the ``RPTR_TRAVERSAL_V1`` route on the
CPU.

- The packet walk (``traverse_v1.plain``, the reference's function) and the
  wrappers on CPU tensors against the reference's ``closest_hit_pallas`` /
  ``occluded_pallas`` / ``closest_and_occluded_pallas`` run in Pallas
  interpret mode. The reference's own tests never run K8, and its module
  has no interpret switch, so ``_interpret`` swaps the module attribute
  ``traverse_pallas.pl`` for an object that forwards ``pallas_call(...,
  interpret=True)``, and restores it after the call; nothing in the JAX
  package changes. Two layouts: terrain(12), 242 triangles, the row-major
  (384, 16) table (K8a), and terrain(70), 9,522 triangles, the field-major
  (16, 14336) one (K8b). Queues of coherent and incoherent rays whose last
  packet is partly filled (1,724 lanes = 3 x 512 + 188). Triangles and
  flags exact; t within 1e-5 relative, u and v within 1e-4 absolute: XLA
  contracts the barycentric dot products into FMAs, as
  tests/test_torch_merged.py says for K1, K2 and K4 (measured here: u up to
  8.6e-5 apart on the K8b queue).
- The plain v1 walk against the plain K1 walk on the same leaf-128 tree:
  a packet walk and a per-ray walk differ only at grazing corners, and on
  these queues nowhere (the count of differing lanes is asserted).
- K8a's and K8b's plain version, the per-lane walk ``plain_lanes`` (K1's
  plain walk over the v1 tables), against the packet ``plain`` (bitwise;
  the grazing lanes where they differ are counted, 0 here) and the
  reference's ``_kernel`` / ``_kernel_lane`` in interpret mode, closest,
  any-hit and merged, on the row-major and field-major grids and on a tie
  scene (``test_torch_cuda.tie_world``, the table forced field-major) whose
  rays hit equal-t triangles in two leaves; the wrappers take
  ``plain_lanes`` in either layout on the CPU.
- The route: ``RPTR_TRAVERSAL_V1`` wins over ``RPTR_TRAVERSAL_V3=1``, the
  streamed route above 90,000 triangles ignores it, ``set_scene`` packs
  the row-major table for cornell and the field-major one for 9,522
  triangles, no wavefront executor by default, and ``compact`` changes no
  result.
- A small V1 render (cornell 16x16, depth 3) through both packages on the
  same scene arrays, the reference's integrator with ``use_pallas=True,
  kernel_v3=False`` on ``pack_for_pallas`` buffers through the shim, run op
  by op, at the 1% / 1e-4 gate with ray counts exact; the port's V1 frame
  equals its K1 frame bitwise (both trees are one 128-row leaf), and its
  ``PT_WAVEFRONT`` sample 0, one merged K8 call per later bounce, equals
  the megakernel's sample 0 bitwise.
"""

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend.renderer import (
    Renderer as JaxRenderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural as jproc
from realtimepathtracingresearchframework_tpu.models.scene import Scene as JaxScene
from realtimepathtracingresearchframework_tpu.ops import bvh as jbvh
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu.ops import traverse_pallas as jtp
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend import renderer as trend
from realtimepathtracingresearchframework_tpu_torch.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    VARIANT_MEGAKERNEL,
    VARIANT_WAVEFRONT,
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_resident as tr
from realtimepathtracingresearchframework_tpu_torch.ops import traverse_v1 as tv
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_cuda import tie_world  # noqa: E402
from test_traverse_kernels import _rays, _terrain  # noqa: E402
from test_torch_wavefront import _env  # noqa: E402

torch.set_num_threads(1)  # see tests/test_torch_render.py

GRIDS = {"wide": 12, "lane": 70}  # 242 and 9,522 triangles
N_COH, N_INC = 1024, 700  # 1,724 lanes: the last packet holds 188
N_S = 900  # shadow queue lanes (last packet 388)


class _InterpretPl:
    """``traverse_pallas.pl`` with every ``pallas_call`` in interpret mode."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


@contextlib.contextmanager
def _interpret():
    pl = jtp.pl
    jtp.pl = _InterpretPl(pl)
    try:
        yield
    finally:
        jtp.pl = pl


@functools.lru_cache(maxsize=None)
def _tree(layout):
    return jbvh.build_threaded_bvh(*_terrain(GRIDS[layout]), leaf_size=128,
                                   builder="sah")


def _soa(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Vec3(*(t[:, k].contiguous() for k in range(3)))


def _comps(a, lib):
    return tuple(lib(np.ascontiguousarray(a[:, k], np.float32)) for k in range(3))


@functools.lru_cache(maxsize=None)
def _queues():
    """Closest queue (coherent, then incoherent rays, 10% of lanes dead),
    occlusion segments of it (just short of or past each closest hit of
    the reference), and a shadow queue toward the sun with open and closed
    segments, numpy."""
    rng = np.random.default_rng(7)
    ro_a, rd_a = _rays(N_COH, rng, "coherent")
    ro_b, rd_b = _rays(N_INC, rng, "incoherent")
    ro = np.concatenate([ro_a, ro_b]).astype(np.float32)
    rd = np.concatenate([rd_a, rd_b]).astype(np.float32)
    n = len(ro)
    tmax = np.where(rng.uniform(size=n) < 0.1, 0.0, 2.0e32).astype(np.float32)
    ro_s = rng.uniform(-4, 4, (N_S, 3)).astype(np.float32)
    ro_s[:, 1] = rng.uniform(-0.6, 0.8, N_S)
    sun = np.array([0.4, 0.7, 0.2], np.float32)
    rd_s = np.broadcast_to(sun / np.linalg.norm(sun), ro_s.shape).astype(np.float32)
    tmax_s = rng.choice(np.array([0.0, 0.5, 2.0, 30.0], np.float32), N_S)
    return (ro, rd, tmax), (ro_s, rd_s, np.full(N_S, 1e-3, np.float32), tmax_s)


@functools.lru_cache(maxsize=None)
def _reference(layout):
    """The reference K8 in interpret mode on the queues: closest hits,
    occlusion of segments scaled 0.999 / 1.001 of each hit, the merged
    launch. Numpy results."""
    bb = jtp.pack_for_pallas(_tree(layout))
    (ro, rd, tmax), (ro_s, rd_s, tmin_s, tmax_s) = _queues()
    with _interpret():
        hit = jtp.closest_hit_pallas(bb, jnp.asarray(ro), jnp.asarray(rd),
                                     t_max=jnp.asarray(tmax))
        t = np.asarray(hit.t)
        scale = np.where(np.arange(len(t)) % 2 == 0, 0.999, 1.001)
        tmax_o = np.where(t < 1e30, t * scale, 1e30).astype(np.float32)
        occ = jtp.occluded_pallas(bb, jnp.asarray(ro), jnp.asarray(rd),
                                  t_max=jnp.asarray(tmax_o))
        m_hit, m_blocked = jtp.closest_and_occluded_pallas(
            bb, _comps(ro, jnp.asarray) + _comps(rd, jnp.asarray), 0.0,
            jnp.asarray(tmax),
            _comps(ro_s, jnp.asarray) + _comps(rd_s, jnp.asarray),
            jnp.asarray(tmin_s), jnp.asarray(tmax_s))

    def np_hit(h):
        return tuple(np.asarray(x) for x in h)

    return {"closest": np_hit(hit), "tmax_o": tmax_o,
            "anyhit": np.asarray(occ),
            "merged": (np_hit(m_hit), np.asarray(m_blocked))}


def _assert_hit_close(hit, ref):
    t, tri, u, v = ref
    np.testing.assert_array_equal(hit.tri.numpy(), tri)
    np.testing.assert_allclose(hit.t.numpy(), t, rtol=1e-5, atol=0)
    for port, want in ((hit.u, u), (hit.v, v)):
        np.testing.assert_allclose(port.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("layout", sorted(GRIDS))
def test_pack_matches_pack_for_pallas(layout):
    """pack_v1 is pack_for_pallas with int links: the same node bounds, skip
    and leaf rows, table (its layout picked by the padded row count) and
    row map."""
    tb = _tree(layout)
    bb = jtp.pack_for_pallas(tb)
    vb = tv.pack_v1(tb)
    assert vb.wide == (layout == "wide") == (bb.tris_s.shape[1] == 16)
    np.testing.assert_array_equal(vb.tris.numpy(), np.asarray(bb.tris_s))
    np.testing.assert_array_equal(vb.row_tri.numpy(), np.asarray(bb.row_tri))
    nodes = np.asarray(bb.nodes)
    np.testing.assert_array_equal(vb.bounds.numpy(), nodes[:, 0:6])
    np.testing.assert_array_equal(vb.links.numpy(), nodes[:, 6:8].astype(np.int32))
    assert vb.num_rows % tv.LEAF == 0


def test_pack_needs_leaf_128():
    tb = jbvh.build_threaded_bvh(*_terrain(8), leaf_size=32)
    with pytest.raises(ValueError, match="leaf_size=128"):
        tv.pack_v1(tb)


@pytest.mark.parametrize("wide", [True, False])
def test_prep_rays_matches_reference(wide):
    """The packed operand and its dead padding lanes (ro 0, rd +x, tmin =
    tmax = 0), which vote in the last packet's any-live test, as
    ``_prep_rays`` lays them out in either orientation."""
    (ro, rd, tmax), _ = _queues()
    ref, n = jtp._prep_rays(jnp.asarray(ro), jnp.asarray(rd), 0.0,
                            jnp.asarray(tmax), tv.BLOCK, wide=wide)
    rays, n2 = tv.prep_rays(_soa(ro), _soa(rd), 0.0, torch.from_numpy(tmax), wide)
    assert n == n2 == len(ro) and rays.is_contiguous()
    np.testing.assert_array_equal(rays.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["closest", "anyhit", "merged"])
@pytest.mark.parametrize("layout", sorted(GRIDS))
def test_plain_matches_reference(layout, mode):
    ref = _reference(layout)
    vb = tv.pack_v1(_tree(layout))
    (ro, rd, tmax), (ro_s, rd_s, tmin_s, tmax_s) = _queues()
    if mode == "closest":
        hit = tv.closest_hit_v1(vb, _soa(ro), _soa(rd), 0.0, torch.from_numpy(tmax))
        _assert_hit_close(hit, ref["closest"])
        assert 0.2 < (hit.tri >= 0).float().mean() < 0.9
    elif mode == "anyhit":
        blocked = tv.occluded_v1(vb, _soa(ro), _soa(rd), 0.0,
                                 torch.from_numpy(ref["tmax_o"]))
        np.testing.assert_array_equal(blocked.numpy(), ref["anyhit"])
        assert 0.1 < blocked.float().mean() < 0.9
    else:
        hit, blocked = tv.closest_and_occluded_v1(
            vb, _comps(ro, torch.from_numpy) + _comps(rd, torch.from_numpy), 0.0,
            torch.from_numpy(tmax),
            _comps(ro_s, torch.from_numpy) + _comps(rd_s, torch.from_numpy),
            torch.from_numpy(tmin_s), torch.from_numpy(tmax_s))
        ref_hit, ref_blocked = ref["merged"]
        _assert_hit_close(hit, ref_hit)
        np.testing.assert_array_equal(blocked.numpy(), ref_blocked)
        assert blocked.any() and not blocked.all()
        # the merged launch is the two single-mode walks, bitwise
        sep = tv.closest_hit_v1(vb, _soa(ro), _soa(rd), 0.0, torch.from_numpy(tmax))
        sep_b = tv.occluded_v1(vb, _soa(ro_s), _soa(rd_s), torch.from_numpy(tmin_s),
                               torch.from_numpy(tmax_s))
        for a, b in zip(hit, sep):
            assert torch.equal(a, b)
        assert torch.equal(blocked, sep_b)


@pytest.mark.parametrize("layout", sorted(GRIDS))
def test_plain_matches_k1_walk(layout):
    """The packet walk against K1's per-ray walk over the same leaf-128
    tree: every lane's triangle, t, u and v equal (they differ only at
    grazing corners, and there are none on these queues), and so are the
    occlusion flags."""
    tb = _tree(layout)
    vb, rb = tv.pack_v1(tb), tr.pack_resident(tb)
    (ro, rd, tmax), _ = _queues()
    o, d, tm = _soa(ro), _soa(rd), torch.from_numpy(tmax)
    hv = tv.closest_hit_v1(vb, o, d, 0.0, tm, map_tri=False)
    h1 = tr.closest_hit_resident(rb, o, d, 0.0, tm)
    differ = int((hv.tri != h1.tri).sum())
    assert differ == 0
    for a, b in zip(hv, h1):
        np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))
    tmax_o = torch.from_numpy(_reference(layout)["tmax_o"])
    assert torch.equal(tv.occluded_v1(vb, o, d, 0.0, tmax_o),
                       tr.occluded_resident(rb, o, d, 0.0, tmax_o))


def _lane_modes(vb, rays, orays):
    """(mode, per-lane output, packet output, first any-hit lane) of the
    plain versions on packed operands in the table's layout: closest on
    ``rays``, any-hit on ``orays``, and the merged launch of ``rays``' whole
    packets, then ``orays``' as its shadow packets."""
    axis = 1 if vb.wide else 0
    np_c = rays.shape[axis]
    merged = torch.cat([rays, orays], dim=axis).contiguous()
    return [(name, tv.plain_lanes(vb, q, a, f), tv.plain(vb, q, a, f), first)
            for name, q, a, f, first in (
                ("closest", rays, False, -1, np_c),
                ("anyhit", orays, True, -1, 0),
                ("merged", merged, False, np_c // tv.BLOCK, np_c))]


def _grazing_lanes(vb, modes):
    """The lanes where per-lane and packet outputs differ: on closest lanes
    any value (bitwise), on any-hit lanes the flag."""
    differ = 0
    for _, lanes, packet, first in modes:
        bits = [(x if vb.wide else x.t()).contiguous().view(torch.int32)
                for x in (lanes, packet)]
        differ += int((bits[0][:, :first] != bits[1][:, :first]).any(dim=0).sum())
        differ += int(((bits[0][1, first:] >= 0) != (bits[1][1, first:] >= 0)).sum())
    return differ


@pytest.mark.parametrize("layout", sorted(GRIDS))
def test_lanes_plain_matches_packet_and_reference(layout):
    """The per-lane plain version (K8a's and K8b's function) on the
    row-major terrain(12) table (242 tris) and the field-major grid (9,522
    tris): against the packet walk bitwise on every closest lane (t, row,
    u, v) and on the any-hit flags, the grazing lanes where they differ
    counted (none on these queues); against the reference's ``_kernel`` /
    ``_kernel_lane`` in interpret mode at the file's tolerance, closest,
    any-hit and merged."""
    ref = _reference(layout)
    vb = tv.pack_v1(_tree(layout))
    wide = layout == "wide"
    assert vb.wide == wide
    (ro, rd, tmax), (ro_s, rd_s, tmin_s, tmax_s) = _queues()
    rays, n = tv.prep_rays(_soa(ro), _soa(rd), 0.0, torch.from_numpy(tmax), wide)
    orays, _ = tv.prep_rays(_soa(ro), _soa(rd), 0.0,
                            torch.from_numpy(ref["tmax_o"]), wide)
    modes = _lane_modes(vb, rays, orays)
    assert _grazing_lanes(vb, modes) == 0
    closest, anyhit = modes[0][1], modes[1][1]
    _assert_hit_close(tv._hit(vb, *tv._fields(vb, closest, 0, n), True),
                      ref["closest"])
    np.testing.assert_array_equal(
        (tv._fields(vb, anyhit, 0, n)[1] >= 0).numpy(), ref["anyhit"])
    # the merged wrapper on the reference's two queues
    hit, blocked = tv.closest_and_occluded_v1(
        vb, _comps(ro, torch.from_numpy) + _comps(rd, torch.from_numpy), 0.0,
        torch.from_numpy(tmax),
        _comps(ro_s, torch.from_numpy) + _comps(rd_s, torch.from_numpy),
        torch.from_numpy(tmin_s), torch.from_numpy(tmax_s))
    ref_hit, ref_blocked = ref["merged"]
    _assert_hit_close(hit, ref_hit)
    np.testing.assert_array_equal(blocked.numpy(), ref_blocked)


def _tie_case():
    """The tie scene's triangles in one leaf-128 SAH tree (the JAX
    package's builder), and its rays (ro, rd, tmax, any-hit tmax)."""
    (v0, e1, e2), rays = tie_world()
    return jbvh.build_threaded_bvh(v0, e1, e2, leaf_size=128, builder="sah"), rays


def test_tie_scene_has_ties_across_leaves():
    """The tie scene's rays reach their nearest t on triangles of two
    leaves (the instances that share a transform), so the walk's order
    decides which triangle they report."""
    tb, (ro, rd, tmax, _) = _tie_case()
    rows = torch.from_numpy(np.asarray(tb.tri_rows[:, 0:9], np.float32))
    o, d = (torch.from_numpy(a)[:, None, :] for a in (ro, rd))
    ok, _, _, tt = tr.traverse._mt_rows(rows[None], *(o[..., k] for k in range(3)),
                                        *(d[..., k] for k in range(3)))
    hit = ok & (tt > 0) & (tt < torch.from_numpy(tmax)[:, None])
    tt = torch.where(hit, tt, 2.0e32)
    least = tt == tt.amin(dim=1, keepdim=True)
    leaves = [torch.unique(torch.nonzero(least[i] & hit[i])[:, 0] // 128).numel()
              for i in range(len(ro))]
    assert sum(k >= 2 for k in leaves) >= 16


@pytest.mark.parametrize("mode", ["closest", "anyhit", "merged"])
def test_tie_scene_lanes_packet_and_reference(mode, monkeypatch):
    """The tie scene packed field-major (both packages' row-count threshold
    set to 0 for the call): per-lane plain, packet plain and the
    reference's ``_kernel_lane`` in interpret mode agree exactly (the
    arithmetic is exact in any order): triangle ids and t bitwise, u and v
    bitwise, any-hit flags equal; no grazing lane."""
    monkeypatch.setattr(tv, "WIDE_MAX_ROWS", 0)
    monkeypatch.setattr(jtp, "WIDE_MAX_ROWS", 0)
    tb, (ro, rd, tmax, otm) = _tie_case()
    vb, bb = tv.pack_v1(tb), jtp.pack_for_pallas(tb)
    assert not vb.wide and bb.tris_s.shape[0] == 16
    n = len(ro)
    rays, _ = tv.prep_rays(_soa(ro), _soa(rd), 0.0, torch.from_numpy(tmax), False)
    orays, _ = tv.prep_rays(_soa(ro), _soa(rd), 0.0, torch.from_numpy(otm), False)
    modes = [m for m in _lane_modes(vb, rays, orays) if m[0] == mode]
    assert _grazing_lanes(vb, modes) == 0
    out, first = modes[0][1], modes[0][3]
    with _interpret():
        if mode == "closest":
            want = jtp.closest_hit_pallas(bb, jnp.asarray(ro), jnp.asarray(rd),
                                          t_max=jnp.asarray(tmax), map_tri=False)
        elif mode == "anyhit":
            want = jtp.occluded_pallas(bb, jnp.asarray(ro), jnp.asarray(rd),
                                       t_max=jnp.asarray(otm))
        else:
            comps = _comps(ro, jnp.asarray) + _comps(rd, jnp.asarray)
            want = jtp.closest_and_occluded_pallas(
                bb, comps, 0.0, jnp.asarray(tmax), comps, 0.0, jnp.asarray(otm),
                map_tri=False)
    if mode == "anyhit":
        flags = tv._fields(vb, out, 0, n)[1] >= 0
        np.testing.assert_array_equal(flags.numpy(), np.asarray(want))
        assert flags.any() and not flags.all()
        return
    hit_want = want if mode == "closest" else want[0]
    got = tv._fields(vb, out, 0, n)
    for a, b in zip(got, hit_want):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    assert (got[1] >= 0).any() and (got[0][got[1] >= 0] == 5.0).all()
    if mode == "merged":
        flags = tv._fields(vb, out, first, first + n)[1] >= 0
        np.testing.assert_array_equal(flags.numpy(), np.asarray(want[1]))


def test_wrappers_pick_the_plain_version_by_layout(monkeypatch):
    """On CPU tensors the wrappers run the per-lane walk, K8a's and K8b's
    function, for a row-major table (K8a) and a field-major one (K8b); the
    packet walk is the reference's function, checked apart."""
    calls = []
    for name in ("plain", "plain_lanes"):
        fn = getattr(tv, name)
        monkeypatch.setattr(tv, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    (ro, rd, tmax), _ = _queues()
    for layout, want in (("wide", "plain_lanes"), ("lane", "plain_lanes")):
        vb = tv.pack_v1(_tree(layout))
        calls.clear()
        tv.closest_hit_v1(vb, _soa(ro[:600]), _soa(rd[:600]))
        tv.occluded_v1(vb, _soa(ro[:600]), _soa(rd[:600]), 0.0, 1.0)
        comps = _comps(ro[:600], torch.from_numpy) + _comps(rd[:600], torch.from_numpy)
        tv.closest_and_occluded_v1(vb, comps, 0.0, 2.0e32, comps, 0.0, 1.0)
        assert calls == [want] * 3


def test_compact_is_ignored():
    """``compact`` is accepted and changes nothing: the reference never
    passes it on (traverse_pallas.py:502-538, :600-623)."""
    vb = tv.pack_v1(_tree("wide"))
    (ro, rd, tmax), (ro_s, rd_s, tmin_s, tmax_s) = _queues()
    o, d, tm = _soa(ro), _soa(rd), torch.from_numpy(tmax)
    for a, b in zip(tv.closest_hit_v1(vb, o, d, 0.0, tm, compact=True),
                    tv.closest_hit_v1(vb, o, d, 0.0, tm)):
        assert torch.equal(a, b)
    assert torch.equal(tv.occluded_v1(vb, o, d, 0.0, tm, compact=True),
                       tv.occluded_v1(vb, o, d, 0.0, tm))
    args = (vb, _comps(ro, torch.from_numpy) + _comps(rd, torch.from_numpy), 0.0, tm,
            _comps(ro_s, torch.from_numpy) + _comps(rd_s, torch.from_numpy),
            torch.from_numpy(tmin_s), torch.from_numpy(tmax_s))
    (h_a, b_a), (h_b, b_b) = (tv.closest_and_occluded_v1(*args, compact=True),
                              tv.closest_and_occluded_v1(*args))
    assert all(torch.equal(a, b) for a, b in zip(h_a, h_b)) and torch.equal(b_a, b_b)


@pytest.mark.parametrize("env,num_tris,want", [
    ({"RPTR_TRAVERSAL_V1": "1"}, 1_000, "v1"),
    ({"RPTR_TRAVERSAL_V1": "1"}, 16_384, "v1 compact"),
    ({"RPTR_TRAVERSAL_V1": "1", "RPTR_TRAVERSAL_V3": "1"}, 50_000, "v1 compact"),
    ({"RPTR_TRAVERSAL_V1": "1"}, 90_001, "streamed"),
    ({"RPTR_TRAVERSAL_V1": "1", "RPTR_FORCE_STREAMED_TRAVERSAL": "1"}, 1_000,
     "streamed"),
], ids=["small", "compact", "over-v3", "large", "forced-streamed"])
def test_route_v1(env, num_tris, want):
    """route_for under RPTR_TRAVERSAL_V1 (renderer.py:815-847): leaf 128, no
    flat cull even with V3=1, the sort flag from 16,384 triangles, and no
    host wavefront executor or carry compaction by default (they key on the
    flat cull); the streamed route ignores V1."""
    with _env(**env):
        route = trend.route_for(num_tris)
        r = Renderer(device="cpu")
        r._route, r.device_scene = route, object()
        cfg = r._integrator_config(RenderParams())
    if want == "streamed":
        assert route.streamed and not route.v1 and not cfg.traversal_v1
        return
    assert route.v1 and cfg.traversal_v1 and route.leaf_size == tv.LEAF
    assert not (route.kernel_v3 or cfg.kernel_v3 or cfg.compact_lanes)
    assert cfg.compact == route.compact == ("compact" in want)
    assert not r._use_wavefront_host(cfg)


@pytest.mark.parametrize("scene,wide", [("cornell", True), ("terrain69", False)])
def test_set_scene_packs_v1(scene, wide):
    """set_scene under RPTR_TRAVERSAL_V1 builds the SAH tree at leaf 128 and
    packs it for K8a or K8b by its padded row count; attributes in row
    order."""
    vkr = (procedural.cornell_box() if scene == "cornell"
           else procedural.terrain(grid=69))
    with _env(RPTR_TRAVERSAL_V1="1"):
        r = Renderer(device="cpu")
        r.initialize(8, 8)
        r.set_scene(Scene.from_vkr_scene(vkr))
    bvh = r.device_scene.bvh
    assert isinstance(bvh, tv.V1BVH) and r._route.v1 and bvh.wide == wide
    assert r.device_scene.attr_packed.shape[1] == bvh.row_tri.shape[0]


# ---------------------------------------------------------------------------
# A small V1 render
# ---------------------------------------------------------------------------

SIZE, DEPTH = 16, 3


def test_v1_render_matches_jax_op_by_op():
    """Cornell 16x16 depth 3, 2 samples, through both integrators on the
    same scene arrays and the same leaf-128 tree: the reference's on K8 in
    interpret mode (``use_pallas=True, kernel_v3=False``,
    ``pack_for_pallas``), op by op outside the kernel; the port's on the
    plain K8. Ray counts per lane exact; radiance at a relative L1 error of
    1e-4 and at most 2% of pixels over 1e-3. Not ``compare_ref``'s mean
    relative error: at 256 pixels one near-black pixel whose NEE sample of
    the area light flips decides the mean (goldens.py says why), and the
    port's K1 route misses that gate by as much against the reference's
    XLA walk run op by op on this frame (measured: pixel 249, 0 against
    7.9e-6, mean relative error 3.9e-3, relative L1 1.5e-5, 0.78% of pixels
    over 1e-3); here 8.1e-5 relative L1, 1.56% of pixels (4) over 1e-3,
    the interpreted kernel's FMAs moving u and v in their last bits."""
    scene, cam, params, sc = goldens.config("cornell_diffuse")
    params = params.replace(max_path_depth=DEPTH)
    jr = JaxRenderer()
    jr.initialize(SIZE, SIZE)
    jr.set_scene(JaxScene.from_vkr_scene(jproc.cornell_box()), scene_config=sc)
    flat = jr.scene.flatten_world()
    tb = jbvh.build_threaded_bvh(flat.v0, flat.e1, flat.e2, leaf_size=128,
                                 builder="sah")
    jds = jr.device_scene
    rows = np.clip(np.asarray(tb.row_tri), 0, flat.num_tris - 1)
    attr = np.asarray(jds.attr_packed)
    jds = jds._replace(bvh=jtp.pack_for_pallas(tb),
                       attr_packed=jnp.asarray(attr[:, rows]))
    jcfg = jr._integrator_config(params)._replace(
        use_pallas=True, kernel_v3=False, row_attrs=True)
    arrays = {"bvh.nodes": tb.nodes, "bvh.tri_rows": tb.tri_rows,
              "bvh.row_tri": tb.row_tri, "bvh.leaf_size": 128,
              "attr_packed": attr, "mat_packed": np.asarray(jds.mat_packed)}
    for k in ("v0", "v1", "v2", "radiance"):
        arrays[f"lights.{k}"] = np.asarray(getattr(jds.lights, k))
    for f in ti.SkyParams._fields:
        arrays[f"sky.{f}"] = np.asarray(getattr(jds.sky, f))
    tds = ti.device_scene_from_numpy(arrays, "cpu")._replace(bvh=tv.pack_v1(tb))
    tcfg = ti.IntegratorConfig(max_path_depth=DEPTH, num_lights=jcfg.num_lights,
                               traversal_v1=True)
    px, py, valid, *_ = ti.swizzle_host(SIZE, SIZE)
    basis = cam.view_basis(SIZE, SIZE)
    jview = ji.ViewBuffers(*(jnp.asarray(a) for a in basis))
    tview = ti.ViewBuffers(*(torch.from_numpy(a) for a in basis))
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    port = ref = 0.0
    spp = 2
    for s in range(spp):
        with jax.disable_jit(), _interpret():
            fp = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(0),
                                jnp.uint32(0))
            st = jps.make_state(0, jnp.uint32(s), jnp.uint32(0), jnp.asarray(px),
                                jnp.asarray(py), SIZE, bufs=jds.rng)
            st, ro, rd = ji.camera_setup(jds, jcfg, fp, jview, jnp.asarray(px),
                                         jnp.asarray(py),
                                         jnp.array([SIZE, SIZE], jnp.float32), st)
            rgb_j, _, rays_j = ji.trace_paths(jds, jcfg, fp, ro, rd, st,
                                              lane_mask=jnp.asarray(valid))
        st = tps.make_state(0, s, 0, tpx, tpy, SIZE)
        st, ro, rd = ti.camera_setup(tcfg, tview, tpx, tpy,
                                     (float(SIZE), float(SIZE)), st)
        rgb_t, _, rays_t = ti.trace_paths(tds, tcfg, ti.FrameParams(), ro, rd, st,
                                          lane_mask=torch.from_numpy(valid))
        np.testing.assert_array_equal(rays_t.numpy()[valid], np.asarray(rays_j)[valid])
        port = port + np.stack([c.numpy() for c in rgb_t], -1)[valid] / spp
        ref = ref + np.stack([np.asarray(c) for c in rgb_j], -1)[valid] / spp
    res = goldens.compare_ref(port[None], ref[None].astype(np.float64))
    assert res["finite"] and res["rel_l1"] <= 1e-4, res
    assert res["frac_over_1e-3"] <= goldens.GOLDEN_FRAC_OVER_1E3, res


def _cornell(variant, v1):
    env = {"RPTR_TRAVERSAL_V1": "1"} if v1 else {}
    with _env(**env):
        r = Renderer(device="cpu")
        r.initialize(SIZE, SIZE)
        r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
        r.set_variant(variant)
        _, cam, params, _ = goldens.config("cornell_diffuse")
        r.render(FrameConfig(camera=cam, params=params.replace(
            batch_spp=1, max_path_depth=DEPTH)))
    return r, r.readback_accumulation()


def test_v1_frame_equals_k1_frame(monkeypatch):
    """Cornell's SAH tree is one node at leaf 32 and at leaf 128, with the
    same first 32 rows; the padded rows never hit. So the V1 frame is the
    K1 frame bit for bit, and V1's PT_WAVEFRONT sample 0 (its later bounces
    through merged K8 calls, no separate occlusion call) the megakernel's."""
    calls = {"closest": 0, "merged": 0, "occluded": 0}
    plain = tv.plain_lanes  # what the wrappers run on CPU tensors

    def counted(bvh, rays, any_hit, shadow_from=-1):
        kind = "merged" if shadow_from >= 0 else "occluded" if any_hit else "closest"
        calls[kind] += 1
        return plain(bvh, rays, any_hit, shadow_from)

    monkeypatch.setattr(tv, "plain_lanes", counted)
    r1, k1 = _cornell(VARIANT_MEGAKERNEL, v1=False)
    rv, v1 = _cornell(VARIANT_MEGAKERNEL, v1=True)
    assert r1.device_scene.bvh.num_nodes == rv.device_scene.bvh.num_nodes == 1
    assert isinstance(rv.device_scene.bvh, tv.V1BVH) and rv.device_scene.bvh.wide
    np.testing.assert_array_equal(v1.view(np.int32), k1.view(np.int32))
    assert r1.last_frame_rays() == rv.last_frame_rays()
    assert calls["occluded"] > 0 and calls["merged"] == 0
    calls.update(merged=0, occluded=0)
    rw, wave = _cornell(VARIANT_WAVEFRONT, v1=True)
    assert rw._integrator_config(RenderParams()).wavefront and rw._wavefront is None
    assert calls["merged"] > 0 and calls["occluded"] == 0
    assert rw.last_frame_rays() == rv.last_frame_rays()
    np.testing.assert_array_equal(wave.view(np.int32), v1.view(np.int32))


def test_v1_route_launches_nothing_on_cpu():
    """On CPU tensors the wrappers run the plain version; the launch counts
    stay 0, and a tensor on another device type raises."""
    tv.reset_launches()
    vb = tv.pack_v1(_tree("wide"))
    (ro, rd, tmax), _ = _queues()
    tv.closest_hit_v1(vb, _soa(ro[:10]), _soa(rd[:10]))
    assert tv.launches_k8a == tv.launches_k8b == tv.merged_launches == 0
    rays, _ = tv.prep_rays(_soa(ro[:10]), _soa(rd[:10]), 0.0, 1.0, True)
    with pytest.raises(ValueError, match="no traversal"):
        tv._run(vb, rays.to("meta"), False)
