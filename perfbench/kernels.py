"""The yardstick of the walks: which device kernels are walks, what a ray
costs them at the least, and the card's published peak.

The walk kernels are matched by a substring of their names, as the port's
profiling script matches them (``profile_frame.py::KERNELS``). The least
bytes of a walk: each ray's origin, direction and segment read once (32 B),
and its answer written once: 16 B for a closest hit (t, triangle, u, v),
1 B for an any-hit flag. The operation side of the bound (the pierced
(ray, leaf) pairs) needs a counter inside the walks that the port does not
have yet, so the roofline is the bytes side alone.
"""

from __future__ import annotations

WALK_KERNELS = {
    "K1": "traverse_resident",
    "K2": "flat_cull",
    "K3": "precull",
    "K4": "traverse_streamed",
    "K5": "traverse_binned",
    "K6": "traverse_tlas_kernel",
    "K7": "traverse_tlas_stream",
    "K8": "traverse_v1_kernel",
}

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at 700 W
BYTES_CLOSEST = 32 + 16
BYTES_ANY_HIT = 32 + 1


def is_walk(kernel_name: str) -> bool:
    return any(sub in kernel_name for sub in WALK_KERNELS.values())


def walk_bytes(closest_rays: float, any_hit_rays: float) -> float:
    return BYTES_CLOSEST * closest_rays + BYTES_ANY_HIT * any_hit_rays


def walk_us(trace):
    """Device microseconds of the walk kernels in a trace's frames, or None
    where none ran."""
    if trace is None:
        return None
    walks = [d for name, _, d in trace.kernels if is_walk(name)]
    return sum(walks) if walks else None
