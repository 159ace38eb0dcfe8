"""The raw kind's host NUL check after the device probe (``probe-nul``
span, inside ``probe``: the mask of patterns that hold a 0x00 byte and
their bounds zeroed), ms a batch of the window; none where no probe made
the check (the ranked and digit kinds) or the program has no such
span."""

UNIT = 'ms'


def read(ctx):
    seconds, count = ctx.phase('probe-nul')
    if count == 0 or ctx.batches == 0:
        return None
    return seconds / ctx.batches * 1e3
