"""Reference-parity table-driven pointsets (Sobol / Z-Sobol / blue noise).

Port of the reference's ``ops/pointsets_tables.py`` (:33-229), which draws
the GPU renderer's own sequences from the shipped tables
(``data/pointset_tables.npz``, a byte copy of the reference's):

- Sobol (pointsets/sobol.glsl:81-213): per-pixel LCG-scrambled digits over
  the direction numbers ``sobol_matrix`` (1024 dims x 32 bits);
- Z-Sobol (Z_ORDER_SHUFFLING): Morton-order tile shuffling
  (``morton_sample_id``), the ``sobol_invert`` shift inversion, per-tile
  scrambling and the leading-bit descramble of the first two dims;
- BN (pointsets/bn_rng.glsl:11-78): Heitz-Belcour blue-noise dithered
  Sobol on 128^2 scrambling tiles, in the 1-spp configuration the
  reference compiles.

u32 values ride ``int64`` masked to 32 bits (``ops/rng.py``). The Sobol
fold takes its direction numbers as byte tables (``sobol.fold``), bitwise
the reference's bit-by-bit fold.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops import rng as lcg
from realtimepathtracingresearchframework_tpu_torch.ops import sobol as sobol_mod
from realtimepathtracingresearchframework_tpu_torch.ops.rng import M32

SOBOL_DIMS = 1024
SOBOL_BITS = 32
SOBOL_TILE = 256  # SobolData_TileSize
SOBOL_TILE_BITS = 8
BN_TILE = 128  # BNData_TileSize
BN_DIMS = 256
BN_SCRAMBLE_DIMS = 8
BN_OPTIMIZED_SPP = 1


@functools.lru_cache(maxsize=1)
def _tables_np():
    path = os.path.join(
        os.path.dirname(__file__), "..", "data", "pointset_tables.npz"
    )
    return np.load(path)


def tables_available() -> bool:
    try:
        _tables_np()
        return True
    except OSError:
        return False


# ---------------------------------------------------------------------------
# Sobol point evaluation (sobol.glsl:81-112)
# ---------------------------------------------------------------------------


def sobol_point(fold_tables, index, dim: int, scramble, z_shuffling: bool):
    """sobol_point: the direction numbers of ``dim`` (masked to 1024 dims)
    selected by the bits of ``index``, XOR-folded over ``scramble``.
    ``fold_tables`` is the (1024, 4, 256) byte-table form of the matrix
    (``sobol.fold_tables``); ``dim`` is one Python int for every lane."""
    dim = int(dim) & (SOBOL_DIMS - 1)
    result = scramble ^ sobol_mod.fold(fold_tables[dim], index)
    if z_shuffling and dim < 2:
        # leading-bit descramble for the first two dims (sobol.glsl:93-108)
        result = (result ^ (result << SOBOL_TILE_BITS)) & M32
    return result


# ---------------------------------------------------------------------------
# Z-order sample shuffling (sample_order.glsl + sobol.glsl:114-159)
# ---------------------------------------------------------------------------


def _part1by1(x):
    x = x & 0x0000FFFF
    x = (x ^ (x << 8)) & 0x00FF00FF
    x = (x ^ (x << 4)) & 0x0F0F0F0F
    x = (x ^ (x << 2)) & 0x33333333
    return (x ^ (x << 1)) & 0x55555555


def morton_sample_id(sample_id: int, px, py, tile: int = SOBOL_TILE,
                     hash_tile_id: bool = True, hash_sample_id: bool = False):
    """morton_sample_id (sample_order.glsl:22-73) for power-of-two square
    ``tile`` dims: Z-order linear id with a random per-level permutation
    and orientation (dimension-swap) shuffling."""
    px = px.to(torch.int64) & M32
    py = py.to(torch.int64) & M32
    tile_pcount = tile * tile

    parted_x = _part1by1(px)
    parted_y = _part1by1(py)
    linear = ((parted_y << 1) + parted_x) & M32

    # square power-of-two tile: both dims share the same mask
    min_dim_mask = tile - 1
    interleaved_mask = ((min_dim_mask + 1) * (min_dim_mask + 1) - 1) & M32
    linear = linear & interleaved_mask
    linear = linear | _mul32_scalar((px | py) & (M32 ^ min_dim_mask),
                                   min_dim_mask + 1)
    if not hash_tile_id:
        linear = linear & (tile_pcount - 1)

    scrambled = linear
    # bit vector enabling swap of interleaved dimension pairs
    swap_vec = parted_x ^ parted_y
    swap_vec = (swap_vec | (swap_vec << 1)) & M32

    scramble_mask = interleaved_mask
    sample_hash = (int(lcg.murmur_hash3_mix(0, int(sample_id)))
                   if hash_sample_id else 0)
    sample_hash = torch.full_like(linear, sample_hash)
    ie = 2 * (int(tile).bit_length() - 1)
    while ie > 0:
        perm = lcg.murmur_hash3_finalize(
            lcg.murmur_hash3_mix(sample_hash, linear >> ie))
        swap = (perm & 0x4) != 0
        perm = perm & 0x3
        ie -= 2
        scrambled = scrambled ^ ((perm << ie) & scramble_mask)
        # swap the bit pair if it lies wholly inside the scramble mask
        swap_mask = (0x3 << ie) & M32
        if swap_mask == (scramble_mask & swap_mask):
            scrambled = torch.where(swap, scrambled ^ (swap_vec & swap_mask),
                                    scrambled)
    if hash_tile_id:
        scrambled = scrambled & (tile_pcount - 1)
    return (((int(sample_id) * tile_pcount) & M32) + scrambled) & M32


def sobol_shift_invert(fold_tables, invert_tile, index, index_shift):
    """sobol_shift_invert (sobol.glsl:116-136): the next sample index
    overlapping the same tile pixel after ``index_shift``."""
    idx = (index + index_shift) & M32
    r0 = sobol_mod.fold(fold_tables[0], idx) >> (32 - SOBOL_TILE_BITS)
    r1 = sobol_mod.fold(fold_tables[1], idx) >> (32 - SOBOL_TILE_BITS)
    flat = r1 * SOBOL_TILE + r0
    return (index_shift + invert_tile.reshape(-1)[flat]) & M32


def sobol_sample_id_z(fold_tables, invert_tile, sample_index: int, px, py):
    """get_sobol_rng's Z_ORDER_SHUFFLING index derivation
    (sobol.glsl:169-178): shuffle tile-local Morton ids, then find the
    Sobol sample each pixel takes."""
    sample_offset = morton_sample_id(0, px, py, SOBOL_TILE, True, False) & (
        SOBOL_TILE * SOBOL_TILE - 1)
    shift = (SOBOL_TILE * SOBOL_TILE * int(sample_index)) & M32
    return sobol_shift_invert(fold_tables, invert_tile, sample_offset, shift)


# ---------------------------------------------------------------------------
# Blue-noise dithered Sobol (bn_rng.glsl:32-78), 1-spp optimized mode
# ---------------------------------------------------------------------------


def sample_bnd(bn_sobol, bn_scrambling, pixel_id, sample_id, d: int):
    """sample_bnd with BN_OPTIMIZED_DIMENSION_REPEAT and BN_OPTIMIZED_SPP=1
    (the reference's compiled configuration): the 1-spp ranking tile is
    zero, so the points are the optimized blue-noise ones. ``d`` is one
    Python int for every lane."""
    d = int(d) & M32
    tile_mask = BN_TILE - 1
    not_tile = M32 ^ tile_mask

    x_doffset = d // BN_SCRAMBLE_DIMS
    pixel_id = ((pixel_id + x_doffset) & tile_mask) + (pixel_id & not_tile)
    d = (d & (BN_SCRAMBLE_DIMS - 1)) + (x_doffset // BN_TILE) * BN_SCRAMBLE_DIMS
    d = d & (BN_DIMS - 1)

    # mirroring and mask shifting per sample (the BN_OPTIMIZED_SPP block)
    pixel_id = torch.where((sample_id & BN_OPTIMIZED_SPP) != 0,
                           pixel_id ^ tile_mask, pixel_id)
    pixel_id = torch.where((sample_id & (2 * BN_OPTIMIZED_SPP)) != 0,
                           pixel_id ^ (tile_mask * BN_TILE), pixel_id)
    x_soffset = _mul32_scalar(sample_id // BN_OPTIMIZED_SPP, 73)
    y_soffset = _mul32_scalar(sample_id // BN_OPTIMIZED_SPP, 97)
    pixel_id = (((pixel_id + x_soffset) & tile_mask)
                + (pixel_id & not_tile)) & M32
    row_mask = BN_TILE * (BN_TILE - 1)
    pixel_id = (((pixel_id + _mul32_scalar(y_soffset, BN_TILE)) & row_mask)
                + (pixel_id & (M32 ^ row_mask))) & M32
    # sample_id & (BN_OPTIMIZED_SPP - 1) is 0 at 1 spp: the ranked sample
    # of the all-zero 1-spp ranking tile is 0
    ranking_index = (pixel_id * BN_SCRAMBLE_DIMS
                     + (d & (BN_SCRAMBLE_DIMS - 1))) & M32
    value = bn_sobol.reshape(-1)[d] ^ bn_scrambling[ranking_index]
    return (0.5 + value.to(torch.float32)) / 256.0


def _mul32_scalar(a, c: int):
    return (a * c) & M32 if c < (1 << 16) else lcg._mul32(a, c)
