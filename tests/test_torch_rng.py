"""The port's RNG (realtimepathtracingresearchframework_tpu_torch.ops.rng,
.pointsets) against the JAX package's, bit for bit.

The port carries u32 state as int64 masked to 32 bits (CPU torch uint32
has no add, shift or compare); every output must equal the JAX package's
u32 result exactly, including inputs near 2^32 and pixel-index products
(py * width) that overflow 32 bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimepathtracingresearchframework_tpu.ops import pointsets as jps
from realtimepathtracingresearchframework_tpu.ops import rng as jrng
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets as tps
from realtimepathtracingresearchframework_tpu_torch.ops import rng as trng

torch.set_num_threads(1)  # see tests/test_torch_render.py

EDGE = np.array(
    [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF, 0xDEADBEEF],
    np.uint32,
)


def _u32_inputs(rng, n=4096):
    return np.concatenate(
        [EDGE, rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)]
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq_u32(port, ref):
    port = port.numpy()
    assert port.min() >= 0 and port.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(port.astype(np.uint32), np.asarray(ref))


def test_murmur_mix_bit_exact(rng):
    h, k = _u32_inputs(rng), _u32_inputs(rng)[::-1].copy()
    _eq_u32(trng.murmur_hash3_mix(_t(h), _t(k)),
            jrng.murmur_hash3_mix(jnp.asarray(h), jnp.asarray(k)))


def test_murmur_finalize_bit_exact(rng):
    h = _u32_inputs(rng)
    _eq_u32(trng.murmur_hash3_finalize(_t(h)),
            jrng.murmur_hash3_finalize(jnp.asarray(h)))


@pytest.mark.parametrize("width", [48, 1920, 65537, 0xFFFFFFFF])
def test_lcg_seed_bit_exact(rng, width):
    """Large widths make py * width wrap past 2^32."""
    n = 2048
    px = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    py = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    for sample, shot in ((0, 0), (7, 3), (0xFFFFFFFF, 0xFFFFFFFE)):
        ref = jrng.lcg_seed(
            jnp.uint32(sample), jnp.uint32(shot),
            jnp.asarray(px).astype(jnp.uint32), jnp.asarray(py).astype(jnp.uint32),
            jnp.uint32(width),
        )
        _eq_u32(trng.lcg_seed(sample, shot, _t(px), _t(py), width), ref)


def test_lcg_float_sequence_bit_exact(rng):
    s0 = _u32_inputs(rng)
    s_j, s_t = jnp.asarray(s0), _t(s0)
    for _ in range(6):
        s_j, x_j = jrng.lcg_float(s_j)
        s_t, x_t = trng.lcg_float(s_t)
        _eq_u32(s_t, s_j)
        assert x_t.dtype == torch.float32
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))


@pytest.mark.parametrize("sample,shot,width", [(0, 0, 48), (5, 11, 1920),
                                               (0xFFFFFFFF, 0x12345678, 70000)])
def test_uniform_pointset_bit_exact(rng, sample, shot, width):
    """make_state + the draw sequence of one bounce (draw2t x4, draw1)
    and draw2, as the integrator calls them."""
    n = 1024
    px = rng.integers(0, width, n).astype(np.int32)
    py = rng.integers(0, 70000, n).astype(np.int32)
    bufs = jps.build_rng_buffers(0)
    sj = jps.make_state(0, jnp.uint32(sample), jnp.uint32(shot),
                        jnp.asarray(px), jnp.asarray(py), width, bufs=bufs)
    st = tps.make_state(0, sample, shot, torch.from_numpy(px),
                        torch.from_numpy(py), width)
    _eq_u32(st.s0, sj.s0)
    _eq_u32(st.s1, sj.s1)
    tbufs = tps.build_rng_buffers(0)
    for dim in (2, 0, 6, 4):
        sj, (xj, yj) = jps.draw2t(0, bufs, sj, dim)
        st, (xt, yt) = tps.draw2t(0, tbufs, st, dim)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    sj, xj = jps.draw1(0, bufs, sj, 7)
    st, xt = tps.draw1(0, tbufs, st, 7)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    sj, pj = jps.draw2(0, bufs, sj, 10)
    st, pt = tps.draw2(0, None, st, 10)  # the LCG reads no tables
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    _eq_u32(st.s0, sj.s0)


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_other_pointsets_raise(variant):
    """Blue noise, Sobol and Z-Sobol never draw silent LCG numbers: without
    their tables a draw raises, and with them (tests/test_torch_pointsets.py
    holds them to the JAX package) the second sample's draws are not the
    LCG's."""
    px = torch.arange(256, dtype=torch.int32)
    state = tps.make_state(variant, 1, 0, px, px, 256)
    with pytest.raises(ValueError, match="RngBuffers"):
        tps.draw2t(variant, None, state, 0)
    bufs = tps.build_rng_buffers(variant)
    state = tps.make_state(variant, 1, 0, px, px, 256, bufs=bufs)
    _, (x, _) = tps.draw2t(variant, bufs, state, 0)
    lcg = tps.make_state(0, 1, 0, px, px, 256)
    _, (y, _) = tps.draw2t(0, None, lcg, 0)
    assert not torch.equal(x, y)
