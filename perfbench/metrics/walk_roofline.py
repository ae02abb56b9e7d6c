"""The walks' share (%) of their bytes roofline: the least bytes of the
frame's traced rays by kind (``perfbench/kernels.py``) over the card's HBM
bandwidth, divided by the walks' device time."""

from perfbench.kernels import HBM_BYTES_PER_S, walk_bytes, walk_us


def read(ctx):
    tr, rays = ctx.get("trace"), ctx.get("rays_per_frame")
    us = walk_us(tr)
    if not us or not rays:
        return None
    bound_s = walk_bytes(rays["closest"], rays["any_hit"]) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / tr.frames * 1e-6)
