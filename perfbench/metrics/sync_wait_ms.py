"""Host milliseconds a traced frame spends inside the port's
``rptr.sync.<site>`` spans: the time the host blocks on the device."""

from perfbench.stages import sync_spans, traced_by_port


def read(ctx):
    tr = ctx.get("trace")
    if not traced_by_port(tr):
        return None
    return sum(d for _, _, d in sync_spans(tr)) / tr.frames / 1e3
