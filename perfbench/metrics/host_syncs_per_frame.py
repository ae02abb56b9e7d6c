"""Blocking device-to-host reads of a traced frame: the port's
``rptr.sync.<site>`` spans over the frames."""

from perfbench.stages import sync_spans, traced_by_port


def read(ctx):
    tr = ctx.get("trace")
    if not traced_by_port(tr):
        return None
    return len(sync_spans(tr)) / tr.frames
