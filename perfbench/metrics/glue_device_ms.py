"""Device milliseconds a traced frame of the kernels launched in the
port's ``rptr.closest``, ``rptr.shadow`` and ``rptr.sort`` stages other
than the walks (``perfbench.kernels.is_walk``): the sorts, tables, padding
and permutations around the walks."""

from perfbench.kernels import is_walk
from perfbench.stages import stage_ms


def read(ctx):
    return stage_ms(ctx.get("trace"),
                    ("rptr.closest", "rptr.shadow", "rptr.sort"),
                    keep=lambda name: not is_walk(name))
