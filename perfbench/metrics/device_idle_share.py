"""The share (%) of the traced window in which no device activity ran."""

from perfbench.trace import busy_us


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.device or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us(tr) / tr.window_us)
