"""Share of the traced window in which the card ran no kernel, copy or
set (the union of the trace's device intervals)."""

UNIT = '%'


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
