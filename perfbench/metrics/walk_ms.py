"""Device milliseconds of the walk kernels in a traced frame."""

from perfbench.kernels import walk_us


def read(ctx):
    us = walk_us(ctx.get("trace"))
    return None if us is None else us / ctx["trace"].frames / 1e3
