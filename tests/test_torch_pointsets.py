"""The port's RNG variants (``ops/sobol.py``, ``ops/pointsets_tables.py``,
``ops/pointsets.py``) against the JAX package's, on the CPU.

- Draws, bitwise: ``make_state`` and the draw sequence of the integrator
  (the camera at dims 0-1, then per bounce pos / sel / lobe / dir at
  +2 / +0 / +6 / +4 and roulette at +7) for the Sobol, Z-Sobol and
  blue-noise variants, with the reference's tables (``tables="always"``,
  what ``"auto"`` picks) and without them (``"never"``), on 4,099 pixels
  at several sample indices and shots; and ``draw1`` at every dim from 0
  to 200. Integer states equal, floats equal.
- The byte-table fold (``sobol.fold``, four gathers) bitwise the
  bit-by-bit fold it replaces (``sobol.sobol_value``, the reference's), on
  every dim of both matrices and on indices with every bit pattern class.
- The goldens ``cornell_sobol``, ``cornell_zsbl`` and ``cornell_bn``
  (48x48, 4 spp, depth 3; tests/test_goldens.py:89-108): the port's
  Renderer against the JAX package run op by op on the same scene
  (``goldens.compare_ref``: 1% of pixels over 1e-3, mean relative error
  1e-4; ray counts per sample exact) and against the golden files at the
  gate of ``cornell_diffuse`` (``goldens.compare``: 2% / 5e-3).
- Under Sobol: ``PT_WAVEFRONT`` against the reference run op by op, and
  the AOV pass (``render_aovs``) against the JAX renderer's: the jitter is
  the Sobol draw at dims 0-1.

The JAX references are shared through module-scoped fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderBackendOptions as JaxOptions,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    Renderer as JaxRenderer,
)
from realtimepathtracingresearchframework_tpu.ops import integrator as ji
from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu.ops import (
    pointsets_tables as jptab,
)
from realtimepathtracingresearchframework_tpu_torch import goldens
from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RNG_VARIANT_BN,
    RNG_VARIANT_SOBOL,
    RNG_VARIANT_Z_SBL,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    VARIANT_WAVEFRONT,
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.ops import integrator as ti
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import (
    pointsets_tables as tptab,
)
from realtimepathtracingresearchframework_tpu_torch.ops import sobol as tsobol

torch.set_num_threads(1)  # see tests/test_torch_render.py

VARIANTS = (RNG_VARIANT_BN, RNG_VARIANT_SOBOL, RNG_VARIANT_Z_SBL)
W = H = goldens.SIZE


@pytest.fixture(scope="module")
def buffers():
    """(JAX, port) RngBuffers of every variant and table choice, and the
    JAX draws jitted over a traced dim (one program per variant and
    table choice instead of every op dispatched on its own)."""
    out = {}
    for v in VARIANTS:
        for t in ("always", "never"):
            bj = jps.build_rng_buffers(v, t)
            draw1 = jax.jit(lambda st, d, v=v, bj=bj: jps.draw1(v, bj, st, d))
            draw2t = jax.jit(lambda st, d, v=v, bj=bj: jps.draw2t(v, bj, st, d))
            out[v, t] = (bj, tps.build_rng_buffers(v, t), draw1, draw2t)
    return out


def _eq_state(st, sj):
    for a, b in ((st.s0, sj.s0), (st.s1, sj.s1)):
        a = a.numpy()
        assert a.min() >= 0 and a.max() <= 0xFFFFFFFF
        np.testing.assert_array_equal(a.astype(np.uint32), np.asarray(b))


def _pixels(width, n=4096, seed=5):
    rng = np.random.default_rng(seed)
    px = np.concatenate([[0, width - 1, 255, 256], rng.integers(0, width, n - 4)])
    py = np.concatenate([[0, 1079, 256, 4095], rng.integers(0, 4096, n - 4)])
    return px.astype(np.int32), py.astype(np.int32)


@pytest.mark.parametrize("tables", ["always", "never"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_state_and_bounce_draws_bitwise(buffers, variant, tables):
    """make_state, the camera draw and three bounces of draws in the
    integrator's order, at three (sample, shot) pairs and two widths."""
    bj, bt, jdraw1, jdraw2t = buffers[variant, tables]
    assert bt.reference_tables == bj.reference_tables == (tables == "always")
    for width, sample, shot in ((1920, 0, 0), (1920, 3, 7),
                                (70000, 0x1234567, 0xFFFFFFFE)):
        px, py = _pixels(width)
        sj = jps.make_state(variant, jnp.uint32(sample), jnp.uint32(shot),
                            jnp.asarray(px), jnp.asarray(py), width,
                            bufs=bj)
        st = tps.make_state(variant, sample, shot, torch.from_numpy(px),
                            torch.from_numpy(py), width, bufs=bt)
        _eq_state(st, sj)
        sj, xj = jps.draw2(variant, bj, sj, 0)
        st, xt = tps.draw2(variant, bt, st, 0)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        for bounce in range(3):
            base = 2 + 8 * bounce
            for off in (2, 0, 6, 4):
                sj, (aj, cj) = jdraw2t(sj, jnp.int32(base + off))
                st, (at, ct) = tps.draw2t(variant, bt, st, base + off)
                np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
                np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
            sj, xj = jdraw1(sj, jnp.int32(base + 7))
            st, xt = tps.draw1(variant, bt, st, base + 7)
            np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
            assert xt.dtype == torch.float32
            assert 0.0 <= float(xt.min()) and float(xt.max()) < 1.0
        _eq_state(st, sj)


@pytest.mark.parametrize("tables", ["always", "never"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_draw1_at_every_dim_bitwise(buffers, variant, tables):
    """draw1 at every dim 0-200 in turn from one state (past the
    self-generated matrix's 128 dims, which clamp, and past BN's 8
    scrambling dims)."""
    bj, bt, jdraw1, _ = buffers[variant, tables]
    px, py = _pixels(640, n=1024, seed=9)
    sj = jps.make_state(variant, jnp.uint32(11), jnp.uint32(2), jnp.asarray(px),
                        jnp.asarray(py), 640, bufs=bj)
    st = tps.make_state(variant, 11, 2, torch.from_numpy(px),
                        torch.from_numpy(py), 640, bufs=bt)
    for dim in range(201):
        sj, xj = jdraw1(sj, jnp.int32(dim))
        st, xt = tps.draw1(variant, bt, st, dim)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj), err_msg=str(dim))
    _eq_state(st, sj)


def test_byte_fold_equals_bit_fold():
    """sobol.fold over the byte tables is bitwise the bit-by-bit fold, on
    every dim of the reference's 1024-dim matrix and of the generated one;
    and the table-driven sobol_point equals the reference's at a few dims,
    the Z-shuffled descramble of dims 0-1 included."""
    rng = np.random.default_rng(2)
    idx = np.concatenate([
        [0, 1, 0xFF, 0x100, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
         0xFFFFFFFF, 0xDEADBEEF],
        rng.integers(0, 2**32, 502, dtype=np.uint64)]).astype(np.int64)
    ti_idx = torch.from_numpy(idx)
    for mats in (tptab._tables_np()["sobol_matrix"], tsobol.sobol_matrices()):
        tables = torch.from_numpy(tsobol.fold_tables(mats))
        cols = torch.from_numpy(np.asarray(mats).astype(np.int64))
        assert tables.shape == (mats.shape[0], 4, 256)
        for d in range(mats.shape[0]):
            assert torch.equal(tsobol.fold(tables[d], ti_idx),
                               tsobol.sobol_value(cols, ti_idx, d)), d
    ref = jnp.asarray(tptab._tables_np()["sobol_matrix"])
    tables = torch.from_numpy(tsobol.fold_tables(tptab._tables_np()["sobol_matrix"]))
    scr = rng.integers(0, 2**32, idx.size, dtype=np.uint64).astype(np.uint32)
    for dim in (0, 1, 2, 511, 1023, 1024 + 5):
        for z in (False, True):
            want = jptab.sobol_point(ref, jnp.asarray(idx.astype(np.uint32)),
                                     jnp.int32(dim), jnp.asarray(scr), z)
            got = tptab.sobol_point(tables, ti_idx, dim,
                                    torch.from_numpy(scr.astype(np.int64)), z)
            np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                          np.asarray(want))


def test_unknown_variant_and_missing_tables_raise():
    """An RNG variant outside 0-3 and a Sobol draw without its tables raise
    (no silent LCG); "auto" takes the reference's tables, which are in the
    package."""
    with pytest.raises(ValueError, match="unknown RNG variant"):
        tps.build_rng_buffers(4)
    with pytest.raises(ValueError, match="tables="):
        tps.build_rng_buffers(RNG_VARIANT_SOBOL, tables="sometimes")
    assert tptab.tables_available()
    assert tps.build_rng_buffers(RNG_VARIANT_SOBOL).reference_tables
    assert not tps.build_rng_buffers(0).reference_tables
    state = tps.RngState(torch.zeros(4, dtype=torch.int64),
                         torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="RngBuffers"):
        tps.draw1(RNG_VARIANT_SOBOL, None, state, 0)


# ---------------------------------------------------------------------------
# The three RNG goldens, PT_WAVEFRONT and the AOV pass under Sobol
# ---------------------------------------------------------------------------


def _jax_op_by_op(name, spp=goldens.SPP, wavefront=False):
    """The golden's frame through the JAX renderer's device scene, its
    integrator run op by op (no XLA fusion, so no FMA contraction):
    (H, W, 3) mean of ``spp`` samples and the rays of each sample."""
    scene, cam, params, sc = goldens.config(name)
    jr = JaxRenderer()
    jr.initialize(W, H)
    jr.configure_for(JaxOptions(rng_variant=goldens.RNG_GOLDENS[name]))
    jr.set_scene(scene, scene_config=sc)
    jds = jr.device_scene
    jcfg = jr._integrator_config(params)._replace(wavefront=wavefront)
    assert jds.rng.reference_tables
    px, py, valid, *_ = ti.swizzle_host(W, H)
    view = ji.ViewBuffers(*(jnp.asarray(a) for a in cam.view_basis(W, H)))
    img, rays = 0.0, []
    with jax.disable_jit():
        for s in range(spp):
            fp = ji.FrameParams(jnp.int32(2), jnp.int32(0), jnp.uint32(0),
                                jnp.uint32(0))
            st = jps.make_state(jcfg.rng_variant, jnp.uint32(s), jnp.uint32(0),
                                jnp.asarray(px), jnp.asarray(py), W,
                                bufs=jds.rng)
            st, ro, rd = ji.camera_setup(jds, jcfg, fp, view, jnp.asarray(px),
                                         jnp.asarray(py),
                                         jnp.array([W, H], jnp.float32), st)
            rgb, _, nr = ji.trace_paths(jds, jcfg, fp, ro, rd, st,
                                        lane_mask=jnp.asarray(valid))
            rays.append(int(np.asarray(nr)[valid].sum()))
            img = img + np.stack([np.asarray(c) for c in rgb], -1) / spp
    out = np.zeros((H, W, 3), np.float32)
    out[py[valid], px[valid]] = img[valid]
    return out, rays


def _port(name, spp=goldens.SPP, variant=None):
    """The golden's frame through the port on the CPU, ``spp`` frames of 1
    sample (none with 0): (rgb image, rays of each frame, renderer)."""
    scene, cam, params, sc = goldens.config(name)
    r = Renderer(device="cpu")
    r.initialize(W, H)
    r.configure_for(r.options.replace(rng_variant=goldens.RNG_GOLDENS[name]))
    r.set_scene(scene, scene_config=sc)
    if variant:
        r.set_variant(variant)
    rays = []
    for _ in range(spp):
        r.render(FrameConfig(camera=cam, params=params, scene_config=sc),
                 batch_spp=1)
        rays.append(r.last_frame_rays())
    return r.readback_accumulation()[..., :3].astype(np.float32), rays, r


@pytest.fixture(scope="module")
def golden_runs():
    """name -> (port image, port rays, JAX op-by-op image, JAX rays)."""
    out = {}
    for name in goldens.RNG_NAMES:
        img, rays, _ = _port(name)
        out[name] = (img, rays) + _jax_op_by_op(name)
    return out


@pytest.mark.parametrize("name", goldens.RNG_NAMES)
def test_rng_golden(golden_runs, name):
    """The port against the golden file, at the golden gate (the relative
    L1 error in the mean's place, goldens.L1_GATED)."""
    img = golden_runs[name][0]
    res = goldens.compare(name, img)
    assert res["ok"], res


@pytest.mark.parametrize("name", goldens.RNG_NAMES)
def test_rng_golden_matches_jax_op_by_op(golden_runs, name):
    """Ray counts per sample exact; radiance at goldens.compare_ref's gate."""
    img, rays, ref, ref_rays = golden_runs[name]
    assert rays == ref_rays
    res = goldens.compare_ref(img, ref, name)
    assert res["ok"], res


def test_jax_op_by_op_reading_of_rng_goldens(golden_runs):
    """The reading behind goldens.L1_GATED: the JAX package run op by op
    passes each RNG golden's gate, and on cornell_sobol and cornell_bn
    misses the mean relative error gate by orders of magnitude (a pixel
    the golden leaves at exactly 0.0 that one of its samples lights)."""
    for name in goldens.RNG_NAMES:
        ref = golden_runs[name][2]
        res = goldens.compare(name, ref)
        assert res["ok"], (name, res)
        if name != "cornell_zsbl":
            assert res["mean_rel"] > 1.0, (name, res)
            assert max(res["worst_px"][3]) == 0.0 < max(res["worst_px"][2])


def test_wavefront_under_sobol_matches_jax_op_by_op():
    """PT_WAVEFRONT under Sobol, 1 spp: the deferred shadow queue leaves the
    draws' order and dims those of the megakernel."""
    img, rays, r = _port("cornell_sobol", spp=1, variant=VARIANT_WAVEFRONT)
    assert r._integrator_config(goldens.config("cornell_sobol")[2]).wavefront
    ref, ref_rays = _jax_op_by_op("cornell_sobol", spp=1, wavefront=True)
    assert rays == ref_rays
    res = goldens.compare_ref(img, ref, "cornell_sobol")
    assert res["ok"], res


def test_aov_jitter_under_sobol_matches_jax():
    """The AOV pass's jitter is the Sobol draw at dims 0-1 (aov.py:63-67):
    each AOV buffer of the port's render_aovs against the JAX renderer's
    (the tolerance of tests/test_torch_queries.py) at sample 5, and the
    jitter is not the LCG's. (At sample 0 and shot 0 the two variants draw
    the same first two numbers: Sobol's index 0 folds to 0 and its
    scramble is the LCG's seed.)"""
    scene, cam, params, sc = goldens.config("cornell_sobol")
    _, _, r = _port("cornell_sobol", spp=0)
    jr = JaxRenderer()
    jr.initialize(W, H)
    jr.configure_for(JaxOptions(rng_variant=RNG_VARIANT_SOBOL))
    jr.set_scene(scene, scene_config=sc)
    for rr in (r, jr):
        rr.frame_id = 5  # the next sample's jitter
        rr.render_aovs(FrameConfig(camera=cam, params=params, scene_config=sc))
    for k in (r.AOV_ALBEDO_ROUGHNESS, r.AOV_NORMAL_DEPTH, r.AOV_MOTION_JITTER):
        np.testing.assert_allclose(r.readback_aov(k),
                                   np.asarray(jr.readback_aov(k)),
                                   rtol=1e-5, atol=1e-4)
    jitter = r.readback_aov(r.AOV_MOTION_JITTER)[..., 2:]
    r.configure_for(r.options.replace(rng_variant=0))
    r.render_aovs(FrameConfig(camera=cam, params=params, scene_config=sc))
    lcg = r.readback_aov(r.AOV_MOTION_JITTER)[..., 2:]
    assert np.abs(lcg - jitter).max() > 1e-3
