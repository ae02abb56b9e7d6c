"""Percent of the last traced frame's shaded bounces that ran the fused
``rptr.shade`` kernels (``Renderer.shade_fused_share``, the port's count
of shaded bounces by path); nothing where the program has no such count."""


def read(ctx):
    return ctx.get("spans", {}).get("shade_fused_share")
