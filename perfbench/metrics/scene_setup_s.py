"""The renderer's own set-up span (``Renderer.setup_seconds``): the host
BVH build, pack and upload of ``set_scene``."""


def read(ctx):
    return ctx.get("spans", {}).get("setup_seconds")
