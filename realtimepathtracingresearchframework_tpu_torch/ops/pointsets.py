"""RNG pointset contract — uniform (LCG) variant only.

Port of the uniform branch of the reference's ``ops/pointsets.py``
(``make_state``/``draw1``/``draw2``/``draw2t``, pointsets.py:168-178,
251-299; rendering/defaults.glsl:22-67). The LCG consumes its state
sequentially, so the path-space ``dim`` argument is ignored, exactly like
the reference. The Sobol, Z-Sobol and blue-noise variants are ROADMAP
item 10; asking for one raises instead of silently drawing LCG numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RNG_VARIANT_NAMES,
    RNG_VARIANT_UNIFORM,
)
from realtimepathtracingresearchframework_tpu_torch.ops import rng as lcg


class RngState(NamedTuple):
    s0: torch.Tensor  # int64 holding a u32: LCG state
    s1: torch.Tensor  # int64 holding a u32: unused by the LCG (zeros)


def _require_uniform(variant: int) -> None:
    if variant != RNG_VARIANT_UNIFORM:
        name = (
            RNG_VARIANT_NAMES[variant]
            if 0 <= variant < len(RNG_VARIANT_NAMES) else str(variant)
        )
        raise NotImplementedError(
            f"RNG variant {name} is not ported yet (ROADMAP item 10: Sobol, "
            "Z-Sobol and blue-noise pointsets); only UNIFORM (LCG) is"
        )


def make_state(variant: int, sample_index, shot, px, py, width) -> RngState:
    """GET_RNG analogue (defaults.glsl:34-40) for the uniform variant."""
    _require_uniform(variant)
    s0 = lcg.lcg_seed(sample_index, shot, px, py, width)
    return RngState(s0=s0, s1=torch.zeros_like(s0))


def draw1(variant: int, state: RngState, dim=None):
    """One float; ``dim`` is ignored by the LCG."""
    _require_uniform(variant)
    s0, x = lcg.lcg_float(state.s0)
    return RngState(s0=s0, s1=state.s1), x


def draw2t(variant: int, state: RngState, dim=None):
    """Two floats at (dim, dim+1) -> (state, (x, y)) as a tuple of 1-D
    tensors."""
    _require_uniform(variant)
    s0, x = lcg.lcg_float(state.s0)
    s0, y = lcg.lcg_float(s0)
    return RngState(s0=s0, s1=state.s1), (x, y)


def draw2(variant: int, state: RngState, dim=None):
    """Two floats at (dim, dim+1) -> (state, (N, 2))."""
    state, (x, y) = draw2t(variant, state, dim)
    return state, torch.stack([x, y], dim=-1)
