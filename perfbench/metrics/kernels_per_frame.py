"""Device kernels of a traced frame: the host dispatch's work count."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.frames
