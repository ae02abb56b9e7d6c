"""Device milliseconds a traced frame of the kernels launched in the
port's ``rptr.shade`` stage: hit shading, textures, emission, BSDF
sampling, the alpha test."""

from perfbench.stages import stage_ms


def read(ctx):
    return stage_ms(ctx.get("trace"), ("rptr.shade",))
