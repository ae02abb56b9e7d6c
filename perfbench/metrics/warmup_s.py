"""Seconds of the warm frames before the window, on the harness's clock
(the set-up phase ``warm_frames``)."""


def read(ctx):
    return ctx.get("spans", {}).get("phase.warm_frames")
