"""The device probe's uploads (``probe-upload`` span, inside ``probe``:
the packed patterns and their lengths copied from pageable host memory to
the card), ms a batch of the window; none without the span."""

UNIT = 'ms'


def read(ctx):
    seconds, count = ctx.phase('probe-upload')
    if count == 0 or ctx.batches == 0:
        return None
    return seconds / ctx.batches * 1e3
