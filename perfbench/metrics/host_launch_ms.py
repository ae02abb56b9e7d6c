"""Host milliseconds a traced frame spends inside the kernel launch calls
(the profiler's CUDA runtime events)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.launches:
        return None
    return tr.launch_us / tr.frames / 1e3
