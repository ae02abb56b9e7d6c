"""Cameras.

Matches the reference's camera model:
- view-plane basis from (pos, dir, up, fovy):
  ``img_plane.y = 2*tan(fovy/2)``, ``img_plane.x = y*aspect``,
  ``du = normalize(cross(dir, up)) * plane.x``,
  ``dv = -normalize(cross(du, dir)) * plane.y``,
  ``dir_top_left = dir - du/2 - dv/2``
  (vulkan/render_vulkan.cpp:2880-2902),
- orbit/fly interactive cameras (util/interactive_camera.h:9-65),
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

    def move(self, forward=0.0, right=0.0, upward=0.0):
        dirn = _normalize(np.asarray(self.dir, np.float64))
        r = _normalize(np.cross(dirn, self.up))
        self.pos = np.asarray(self.pos, np.float64) + forward * dirn + right * r
        self.pos = self.pos + upward * _normalize(np.asarray(self.up, np.float64))

    def rotate(self, yaw_rad=0.0, pitch_rad=0.0):
        dirn = _normalize(np.asarray(self.dir, np.float64))
        up = _normalize(np.asarray(self.up, np.float64))
        right = _normalize(np.cross(dirn, up))

        def rot(v, axis, ang):
            axis = _normalize(axis)
            return (
                v * np.cos(ang)
                + np.cross(axis, v) * np.sin(ang)
                + axis * np.dot(axis, v) * (1 - np.cos(ang))
            )

        d = rot(dirn, up, yaw_rad)
        d = rot(d, right, pitch_rad)
        self.dir = _normalize(d)

    def move_local(self, axis, dt: float, speed: float = 1.0):
        """camera.move_local(axis, dt) — axis in camera space with -z
        forward, +x right, +y up (camera_state.h:67-84)."""
        ax = np.asarray(axis, np.float64)
        self.move(
            forward=-ax[2] * dt * speed,
            right=ax[0] * dt * speed,
            upward=ax[1] * dt * speed,
        )

    def pan(self, delta, speed: float = 1.0):
        """camera.pan(mouse_delta): translate in the view plane
        (camera_state.h:58)."""
        dx, dy = float(delta[0]), float(delta[1])
        self.move(right=-dx * speed, upward=-dy * speed)

    def zoom(self, amount: float, speed: float = 1.0):
        """camera.zoom(wheel * 0.1) — dolly along the view direction
        (camera_state.h:62-64)."""
        self.move(forward=float(amount) * speed)
