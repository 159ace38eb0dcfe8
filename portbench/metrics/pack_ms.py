"""The Reader's pattern packing before the device probe (``pack`` span:
``pack_patterns``' padded [B, L] array and lengths), ms a batch of the
window; none where the program has no such span or no batch took the
device probe."""

UNIT = 'ms'


def read(ctx):
    seconds, count = ctx.phase('pack')
    if count == 0 or ctx.batches == 0:
        return None
    return seconds / ctx.batches * 1e3
