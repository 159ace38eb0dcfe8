"""The Reader's device probe (``probe`` phase: packing's upload, K4, the
readback and the raw kind's NUL check), ms a batch of the window; none on
a cell whose batches never take the device probe."""

UNIT = 'ms'


def read(ctx):
    seconds, count = ctx.phase('probe')
    if count == 0:
        return None
    return seconds / ctx.batches * 1e3
