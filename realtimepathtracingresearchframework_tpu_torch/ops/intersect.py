"""Ray-triangle and ray-AABB intersection primitives.

Port of the reference's ``ops/intersect.py`` (intersect.py:14-60):
Möller-Trumbore over precomputed (v0, e1, e2) and the slab test, on
(..., 3) tensors. The slab test takes an axis whose direction component is
exactly 0 as the whole line when the origin lies within the slab
(``slab_interval``), where the reference's products with 1e20 cap a ray on
a box's max face at t = 0; every walk of the port, plain and CUDA
(``csrc/stream_walk.cuh``, ``csrc/flat_cull.cuh``), uses that rule.
"""

from __future__ import annotations

import torch

from realtimepathtracingresearchframework_tpu_torch.utils.profiling import (
    host_sync,
)

T_MAX = 2.0e32  # reference uses 2.e32f (pt_megakernel.glsl:326)
EPS_DET = 1e-12


def ray_tri(ro, rd, v0, e1, e2, t_min, t_max):
    """Möller-Trumbore. All inputs broadcastable; returns (hit, t, u, v).

    ro, rd: (..., 3); v0, e1, e2: (..., 3).
    """
    ro, rd, v0, e1, e2 = torch.broadcast_tensors(ro, rd, v0, e1, e2)
    pvec = torch.linalg.cross(rd, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = torch.where(det.abs() > EPS_DET, 1.0 / det, 0.0)
    tvec = ro - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(rd * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = (
        (det.abs() > EPS_DET)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def slab_interval(lo, hi, o, inv, zero):
    """One axis of the slab test, elementwise: the entry and exit t
    (tsmall, tbig) of the slab [lo, hi] along a ray from ``o`` with inverse
    direction ``inv`` (``safe_inv_dir``). On an axis where the direction is
    exactly 0 (either sign; ``zero``) the slab is (-inf, +inf) when
    lo <= o <= hi and empty otherwise: the products with inv = +-1e20 would
    put the exit of a ray on the max face at 0 and miss a box the ray runs
    along. Every other axis keeps the products' expressions."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tsmall = torch.minimum(t0, t1)
    tbig = torch.maximum(t0, t1)
    inside = (lo <= o) & (o <= hi)
    with host_sync("slab_inf"):  # a copy to the device that waits
        inf = torch.tensor(float("inf"), dtype=tsmall.dtype,
                           device=tsmall.device)
    tsmall = torch.where(zero, torch.where(inside, -inf, inf), tsmall)
    tbig = torch.where(zero, torch.where(inside, inf, -inf), tbig)
    return tsmall, tbig


def ray_aabb(ro, inv_rd, bmin, bmax, t_min, t_max, zero):
    """Slab test. ro/inv_rd/zero: (..., 3) (``zero``: the direction's
    components that are exactly 0, ``rd == 0``); bmin/bmax: (..., 3).
    Returns hit bool and entry t (clamped to t_min)."""
    tsmall, tbig = slab_interval(bmin, bmax, ro, inv_rd, zero)
    tenter = torch.maximum(tsmall.amax(dim=-1), torch.as_tensor(t_min))
    texit = torch.minimum(tbig.amin(dim=-1), torch.as_tensor(t_max))
    return tenter <= texit, tenter


def safe_inv_dir(rd):
    """1/rd with +-inf-free handling of zero components (sign-preserving
    huge value); the slab test treats an exactly zero component apart
    (``slab_interval``)."""
    sign = torch.where(rd >= 0.0, 1.0, -1.0)
    return sign / torch.clamp(rd.abs(), min=1e-20)
