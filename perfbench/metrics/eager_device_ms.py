"""Device milliseconds of a traced frame outside the walks: the eager
shading, NEE, RNG, sorting and accumulation work."""

from perfbench.kernels import walk_us


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.device:
        return None
    total = sum(d for _, _, d in tr.device)
    return (total - (walk_us(tr) or 0.0)) / tr.frames / 1e3
