"""``terrain``: a value-noise heightfield of ``2 grid^2`` untextured
triangles (grid 500: 500,000), one grey material; a frozen copy of the
port's ``procedural.terrain``."""

from __future__ import annotations

import numpy as np

from perfbench.scenes.vks import (
    VkrMaterial,
    height_grid,
    identity_scene,
    make_mesh,
    value_noise_heights,
)


def build(grid: int = 500, extent: float = 20.0, height: float = 2.0,
          seed: int = 7):
    n = grid + 1
    tris = height_grid(n, extent, value_noise_heights(n, height, seed))
    materials = [VkrMaterial(name="Ground",
                             base_color=np.array([0.45, 0.42, 0.32], np.float32))]
    return identity_scene([make_mesh("terrain", tris)], materials)
