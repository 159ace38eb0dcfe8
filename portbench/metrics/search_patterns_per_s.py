"""Patterns answered over the traced window, patterns/s (host clock): the
closed loop's rate, all the window's batches over all its time.  A per-layer
reading: the host's speed moves it by a fifth from run to run, more than
an end-to-end bound may allow, and the profiler is on."""

UNIT = 'patterns/s'


def read(ctx):
    if ctx.batches == 0 or ctx.window_s <= 0:
        return None
    return ctx.patterns / ctx.window_s
