"""RNG pointset contract and variant dispatch.

Port of the reference's ``ops/pointsets.py`` (:43-308): a per-path
``RngState`` seeded from (sample index, shot offset, pixel, width), drawn
from with explicit path-space dimensions (rendering/pathspace.h;
rendering/defaults.glsl:22-67). Variants (render_params.glsl.h:34-43):

- UNIFORM: the murmur-seeded LCG (``ops/rng.py``); it consumes its state
  in order and ignores ``dim``, exactly like the reference;
- SOBOL, Z_SBL and BN with the reference's tables (``tables="auto"``, the
  default, since ``data/pointset_tables.npz`` is in the package, or
  ``"always"``): the GPU renderer's own sequences
  (``ops/pointsets_tables.py``). A Sobol draw advances the state's LCG
  scramble, so the order of draws matters as well as their dims;
- the same variants with ``tables="never"``: Owen-scrambled Sobol over
  self-generated matrices (``ops/sobol.py``), Morton-ordered for Z_SBL,
  dithered by a generated void-and-cluster blue-noise mask for BN.

State is a pair of u32 values carried as ``int64`` masked to 32 bits.
``RngBuffers`` holds the tables on the scene's device, the Sobol matrix
also as per-dimension byte tables (``fold``), so a draw folds its index
in four gathers instead of 32 steps, bitwise the reference's fold.
A draw's ``dim`` is one Python int for every lane.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RNG_VARIANT_BN,
    RNG_VARIANT_SOBOL,
    RNG_VARIANT_UNIFORM,
    RNG_VARIANT_Z_SBL,
)
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets_tables as ptab
from realtimepathtracingresearchframework_tpu_torch.ops import rng as lcg
from realtimepathtracingresearchframework_tpu_torch.ops import sobol as sobol_mod
from realtimepathtracingresearchframework_tpu_torch.ops.rng import M32


class RngBuffers(NamedTuple):
    """The tables of the active pointset on one device (empty for the
    LCG). With the reference's tables ``sobol_invert`` is (256, 256) and
    the draws are the table-driven ones; otherwise the self-generated
    ones. Integer tables are int64 holding u32 values."""

    matrices: torch.Tensor  # (D, 32) Sobol direction numbers
    fold: torch.Tensor  # (D, 4, 256) their byte tables (sobol.fold_tables)
    bn_mask: torch.Tensor  # (64, 64, 8) f32 blue-noise dither offsets
    sobol_invert: torch.Tensor  # (256, 256) with the reference's tables
    bn_sobol: torch.Tensor  # (256, 256)
    bn_scrambling: torch.Tensor  # (128 * 128 * 8,)

    @property
    def reference_tables(self) -> bool:
        return self.sobol_invert.shape[0] == 256


class RngState(NamedTuple):
    s0: torch.Tensor  # int64 holding a u32: LCG state / Sobol index
    s1: torch.Tensor  # int64 holding a u32: scramble key (zeros for the LCG)


@functools.lru_cache(maxsize=1)
def _blue_noise_mask_np(size: int = 64, channels: int = 8) -> np.ndarray:
    """Void-and-cluster blue-noise ranks in [0,1), toroidal (pointsets.py:
    74-134). Generated once (deterministic); independent channels via
    toroidal shifts of one mask."""
    rng = np.random.default_rng(0xB10E)
    n = size * size

    yy, xx = np.mgrid[0:size, 0:size]
    d2 = np.minimum(xx, size - xx) ** 2 + np.minimum(yy, size - yy) ** 2
    kern_f = np.fft.rfft2(np.exp(-d2 / (2.0 * 1.9**2)))

    def filt(binary):
        return np.fft.irfft2(np.fft.rfft2(binary) * kern_f, s=(size, size))

    # initial pattern: 10% random, spread via void-and-cluster swaps
    count = n // 10
    binary = np.zeros((size, size), bool)
    idx = rng.choice(n, count, replace=False)
    binary.reshape(-1)[idx] = True
    for _ in range(2000):
        e = filt(binary.astype(np.float64))
        cluster = np.unravel_index(np.where(binary, e, -np.inf).argmax(), e.shape)
        binary[cluster] = False
        e = filt(binary.astype(np.float64))
        void = np.unravel_index(np.where(binary, np.inf, e).argmin(), e.shape)
        if void == cluster:
            binary[cluster] = True
            break
        binary[void] = True

    rank = np.zeros((size, size), np.int64)
    work = binary.copy()
    # ranks below count: remove the tightest cluster repeatedly
    for r in range(count - 1, -1, -1):
        e = filt(work.astype(np.float64))
        c = np.unravel_index(np.where(work, e, -np.inf).argmax(), e.shape)
        work[c] = False
        rank[c] = r
    # ranks above: fill the largest void repeatedly
    work = binary.copy()
    for r in range(count, n):
        e = filt(work.astype(np.float64))
        v = np.unravel_index(np.where(work, np.inf, e).argmin(), e.shape)
        work[v] = True
        rank[v] = r

    base = (rank.astype(np.float64) + 0.5) / n
    chans = []
    for _ in range(channels):
        sx, sy = rng.integers(0, size, 2)
        chans.append(np.roll(np.roll(base, sx, 0), sy, 1))
    return np.stack(chans, axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fold_np(which: str) -> np.ndarray:
    mats = (ptab._tables_np()["sobol_matrix"] if which == "reference"
            else sobol_mod.sobol_matrices())
    return sobol_mod.fold_tables(mats)


def build_rng_buffers(variant: int, tables: str = "auto",
                      device="cpu") -> RngBuffers:
    """The tables of ``variant`` on ``device`` (pointsets.py:137-166).
    ``tables``: "auto" takes the reference's pointset tables when the data
    file is there (the parity default), "never" the self-generated
    variants, "always" raises if the tables are missing."""
    if tables not in ("auto", "never", "always"):
        raise ValueError(f"tables={tables!r}: expected auto, never or always")

    def dev(a, dtype=torch.int64):
        return torch.from_numpy(np.asarray(a)).to(dtype).to(device)

    empty_u = dev(np.zeros((1, 1), np.int64))
    out = dict(matrices=dev(np.zeros((1, 32), np.int64)),
               fold=dev(np.zeros((1, 4, 256), np.int64)),
               bn_mask=dev(np.zeros((1, 1, 1), np.float32), torch.float32),
               sobol_invert=empty_u, bn_sobol=empty_u,
               bn_scrambling=dev(np.zeros((1,), np.int64)))
    if variant == RNG_VARIANT_UNIFORM:
        return RngBuffers(**out)
    if variant not in (RNG_VARIANT_SOBOL, RNG_VARIANT_Z_SBL, RNG_VARIANT_BN):
        raise ValueError(f"unknown RNG variant {variant}")
    use_ref = tables == "always" or (tables == "auto" and ptab.tables_available())
    if use_ref:
        t = ptab._tables_np()
        out["sobol_invert"] = dev(t["sobol_invert"])
        if variant == RNG_VARIANT_BN:
            out["bn_sobol"] = dev(t["bn_sobol"])
            out["bn_scrambling"] = dev(t["bn_scrambling_1spp"])
        else:
            out["matrices"] = dev(t["sobol_matrix"])
            out["fold"] = dev(_fold_np("reference"))
        return RngBuffers(**out)
    out["matrices"] = dev(sobol_mod.sobol_matrices())
    out["fold"] = dev(_fold_np("generated"))
    if variant == RNG_VARIANT_BN:
        out["bn_mask"] = dev(_blue_noise_mask_np(), torch.float32)
    return RngBuffers(**out)


def _u32(x, like):
    """A Python int or a tensor -> an int64 u32 tensor shaped like ``like``."""
    if isinstance(x, torch.Tensor):
        return (x.to(torch.int64) & M32).expand(like.shape)
    return torch.full_like(like, int(x) & M32)


def make_state(variant: int, sample_index, shot, px, py, width,
               bufs: Optional[RngBuffers] = None) -> RngState:
    """GET_RNG analogue (defaults.glsl:34-40; pointsets.py:168-200). Pass
    ``bufs`` with the reference's tables for their state derivation;
    without them the Sobol variants take the self-generated one."""
    px = px.to(torch.int64) & M32
    py = py.to(torch.int64) & M32
    if variant == RNG_VARIANT_UNIFORM:
        s0 = lcg.lcg_seed(sample_index, shot, px, py, width)
        return RngState(s0=s0, s1=torch.zeros_like(s0))
    if bufs is not None and bufs.reference_tables:
        return _make_state_ref(variant, sample_index, shot, px, py, width, bufs)
    pixel_linear = (px + lcg._mul32(py, int(width) & M32)) & M32
    if variant == RNG_VARIANT_Z_SBL:
        # one global Morton stream: an Owen-shuffled (pixel, sample) index
        log_spp = 12
        base = ((sobol_mod.morton2d(px, py) << log_spp) & M32) | (
            _u32(sample_index, px) & ((1 << log_spp) - 1))
        shot_u = _u32(shot, px)
        idx = sobol_mod._reverse_bits(sobol_mod._lk_hash(
            sobol_mod._reverse_bits(base), 0x55 ^ shot_u))
        return RngState(s0=idx, s1=shot_u)
    # SOBOL / BN: a per-pixel stream
    key = lcg.murmur_hash3_finalize(
        lcg.murmur_hash3_mix(_u32(shot, px), pixel_linear))
    return RngState(s0=_u32(sample_index, px), s1=key)


def _make_state_ref(variant, sample_index, shot, px, py, width, bufs):
    """Reference table-driven GET_RNG (sobol.glsl:160-186, bn_rng.glsl:
    84-95; pointsets.py:202-238). State stays 2 x u32, the reference's own
    PACK_RNG layout."""
    shot_u = _u32(shot, px)
    if variant == RNG_VARIANT_BN:
        # get_bnd_rng: pixelID in a 128^2 tile, sampleID = index + frame*13
        i = px & (ptab.BN_TILE - 1)
        j = py & (ptab.BN_TILE - 1)
        pixel_id = i + j * ptab.BN_TILE
        sample_id = (_u32(sample_index, px) + shot_u * 13) & 0xFFFF
        return RngState(s0=sample_id | (pixel_id << 16), s1=torch.zeros_like(px))
    if variant == RNG_VARIANT_Z_SBL:
        # Z_ORDER_SHUFFLING (sobol.glsl:169-178): a shuffled tile-local
        # sample index and a per-tile scrambling stream
        index = ptab.sobol_sample_id_z(bufs.fold, bufs.sobol_invert,
                                       int(sample_index), px, py)
        tile_w = (int(width) & M32) >> ptab.SOBOL_TILE_BITS
        linear = ((px >> ptab.SOBOL_TILE_BITS)
                  + lcg._mul32(py >> ptab.SOBOL_TILE_BITS, tile_w)) & M32
    else:  # RNG_VARIANT_SOBOL: a per-pixel scrambling stream
        index = _u32(sample_index, px)
        linear = (px + lcg._mul32(py, int(width) & M32)) & M32
    # scramble = get_lcg_rng(frame_id, 0, linear) (sobol.glsl:166,183)
    scr = lcg.murmur_hash3_mix(0, linear)
    scr = lcg.murmur_hash3_mix(scr, shot_u)
    return RngState(s0=index, s1=lcg.murmur_hash3_finalize(scr))


def _require_bufs(variant: int, bufs) -> None:
    if bufs is None:
        raise ValueError(
            f"RNG variant {variant} draws from its RngBuffers "
            "(build_rng_buffers); none were given")


def _sobol_dim(bufs: RngBuffers, variant: int, state: RngState, dim: int):
    """The self-generated Sobol value of ``dim`` (pointsets.py:241-248):
    the fold clamped to the matrix's dims, Owen-scrambled per pixel (per
    dim for Z_SBL)."""
    d = min(max(dim, 0), bufs.fold.shape[0] - 1)
    val = sobol_mod.fold(bufs.fold[d], state.s0)
    if variant == RNG_VARIANT_Z_SBL:
        seed = int(sobol_mod._lk_hash(torch.tensor(dim & M32), 0x9E3779B9))
    else:
        seed = sobol_mod._lk_hash(
            state.s1 ^ ((dim * 0x9E3779B9) & M32), 0xA511E9B3)
    return sobol_mod.owen_scramble(val, seed)


def _bn_offset(bufs: RngBuffers, state: RngState, dim: int):
    """Cranley-Patterson rotation by the generated blue-noise mask,
    indexed by the hashed pixel key and the dim's channel
    (pointsets.py:301-308)."""
    h = sobol_mod._lk_hash(state.s1, 0xB1E)
    x = h & 63
    y = (h >> 6) & 63
    return bufs.bn_mask[x, y, dim % bufs.bn_mask.shape[2]]


def draw1(variant: int, bufs: Optional[RngBuffers], state: RngState, dim):
    """One float at path-space dimension ``dim`` (ignored by the LCG)."""
    if variant == RNG_VARIANT_UNIFORM:
        s0, x = lcg.lcg_float(state.s0)
        return RngState(s0=s0, s1=state.s1), x
    _require_bufs(variant, bufs)
    dim = int(dim)
    if bufs.reference_tables:
        if variant == RNG_VARIANT_BN:
            x = ptab.sample_bnd(bufs.bn_sobol, bufs.bn_scrambling,
                                state.s0 >> 16, state.s0 & 0xFFFF, dim)
            return state, x
        # sobol_randomf: the per-draw scramble ADVANCES the LCG stream
        s1 = lcg.lcg_step(state.s1)
        v = ptab.sobol_point(bufs.fold, state.s0, dim, s1,
                             z_shuffling=variant == RNG_VARIANT_Z_SBL)
        return RngState(s0=state.s0, s1=s1), sobol_mod.u32_to_float(v)
    x = sobol_mod.u32_to_float(_sobol_dim(bufs, variant, state, dim))
    if variant == RNG_VARIANT_BN:
        # x and the offset both lie in [0, 1): fmod is the exact floor mod
        x = torch.fmod(x + _bn_offset(bufs, state, dim), 1.0)
    return state, x


def draw2t(variant: int, bufs: Optional[RngBuffers], state: RngState, dim):
    """Two floats at (dim, dim + 1) -> (state, (x, y)) as a tuple of 1-D
    tensors."""
    if variant == RNG_VARIANT_UNIFORM:
        s0, x = lcg.lcg_float(state.s0)
        s0, y = lcg.lcg_float(s0)
        return RngState(s0=s0, s1=state.s1), (x, y)
    state, x = draw1(variant, bufs, state, dim)
    state, y = draw1(variant, bufs, state, int(dim) + 1)
    return state, (x, y)


def draw2(variant: int, bufs: Optional[RngBuffers], state: RngState, dim):
    """Two floats at (dim, dim + 1) -> (state, (N, 2))."""
    state, (x, y) = draw2t(variant, bufs, state, dim)
    return state, torch.stack([x, y], dim=-1)
