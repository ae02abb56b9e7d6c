"""Device milliseconds a traced frame of the kernels launched in the
port's ``rptr.nee`` stage, its shadow dispatch (``rptr.shadow``) left
out: light selection, the light sample and its contribution."""

from perfbench.stages import stage_ms


def read(ctx):
    return stage_ms(ctx.get("trace"), ("rptr.nee",))
