"""The device probe's readback (``probe-readback`` span, inside ``probe``:
the bounds' ``torch.stack`` and the blocking copy to the host, which
waits for K4), ms a batch of the window; none without the span."""

UNIT = 'ms'


def read(ctx):
    seconds, count = ctx.phase('probe-readback')
    if count == 0 or ctx.batches == 0:
        return None
    return seconds / ctx.batches * 1e3
