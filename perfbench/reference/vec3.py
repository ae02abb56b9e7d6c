"""SoA 3-vectors: three 1-D component tensors instead of one (N, 3) tensor.

Port of the reference's ``ops/vec3.py``. The layout is kept so the port's
public functions take and return what the reference's do; on the GPU it is
also the coalesced layout (neighbouring lanes read neighbouring floats).
Operations keep the reference's expression order, so each result rounds
the way the reference's does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic (component-wise; scalars broadcast) --------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def splat(s) -> Vec3:
    """Scalar (tensor) -> Vec3 with all components equal."""
    return Vec3(s, s, s)


def from_array(v: torch.Tensor) -> Vec3:
    """(..., 3) -> Vec3 of (...,) components."""
    return Vec3(v[..., 0], v[..., 1], v[..., 2])


def to_array(a: Vec3) -> torch.Tensor:
    """Vec3 -> (..., 3)."""
    return torch.stack(torch.broadcast_tensors(a.x, a.y, a.z), dim=-1)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: Vec3):
    return torch.sqrt(dot(a, a))


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = 1.0 / torch.clamp(length(a), min=eps)
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def where(m, a: Vec3, b: Vec3) -> Vec3:
    """Component-wise select by a scalar mask (NOT per-component masks)."""
    return Vec3(
        torch.where(m, a.x, b.x), torch.where(m, a.y, b.y), torch.where(m, a.z, b.z)
    )


def vabs(a: Vec3) -> Vec3:
    return Vec3(a.x.abs(), a.y.abs(), a.z.abs())


def max_component(a: Vec3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def luminance(c: Vec3):
    """Rec.709 luminance (rendering/util.glsl luminance)."""
    return 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """GLSL reflect(i, n) = i - 2*dot(n, i)*n."""
    d2 = 2.0 * dot(n, i)
    return Vec3(i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z)


def refract(i: Vec3, n: Vec3, eta):
    """GLSL refract; returns (r, tir) with r = 0 on total internal
    reflection."""
    n_dot_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    tir = k < 0.0
    c = eta * n_dot_i + torch.sqrt(torch.clamp(k, min=0.0))
    r = Vec3(eta * i.x - c * n.x, eta * i.y - c * n.y, eta * i.z - c * n.z)
    zero = torch.zeros_like(r.x)
    return where(tir, Vec3(zero, zero, zero), r), tir
