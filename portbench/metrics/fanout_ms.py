"""``HostServing``'s line fan-out (``hs-fanout`` phase: the str objects
and the per-pattern lists), ms a batch of the window."""

UNIT = 'ms'


def read(ctx):
    seconds, count = ctx.phase('hs-fanout')
    if count == 0:
        return None
    return seconds / ctx.batches * 1e3
