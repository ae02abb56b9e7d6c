"""Cameras.

Matches the reference's camera model:
- view-plane basis from (pos, dir, up, fovy):
  ``img_plane.y = 2*tan(fovy/2)``, ``img_plane.x = y*aspect``,
  ``du = normalize(cross(dir, up)) * plane.x``,
  ``dv = -normalize(cross(du, dir)) * plane.y``,
  ``dir_top_left = dir - du/2 - dv/2``
  (vulkan/render_vulkan.cpp:2880-2902),
- ray generation: ``normalize(px*du + py*dv + dir_top_left)`` with px,py in
  [0,1] (vulkan/pt_megakernel.glsl:323).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _normalize(v):
    return v / np.linalg.norm(v)


@dataclass
class OrientedCamera:
    """Position/direction/up camera (libapp/camera_state.h)."""

    pos: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 5.0]))
    dir: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fovy: float = 65.0  # degrees (reference default, libapp/scene_state.h)

    @staticmethod
    def look_at(eye, center, up=(0.0, 1.0, 0.0), fovy: float = 65.0):
        eye = np.asarray(eye, np.float64)
        center = np.asarray(center, np.float64)
        return OrientedCamera(
            pos=eye, dir=_normalize(center - eye), up=np.asarray(up, np.float64), fovy=fovy
        )

    def view_basis(self, width: int, height: int):
        """Returns (pos, du, dv, dir_top_left) as float32 arrays."""
        dirn = _normalize(np.asarray(self.dir, np.float64))
        up = np.asarray(self.up, np.float64)
        aspect = width / height
        plane_y = 2.0 * np.tan(np.radians(0.5 * self.fovy))
        plane_x = plane_y * aspect
        du = _normalize(np.cross(dirn, up)) * plane_x
        dv = -_normalize(np.cross(du, dirn)) * plane_y
        top_left = dirn - 0.5 * du - 0.5 * dv
        return (
            np.asarray(self.pos, np.float32),
            du.astype(np.float32),
            dv.astype(np.float32),
            top_left.astype(np.float32),
        )

    # -- interactive movement (default_camera_movement, camera_state.h:48-98)
