"""Card memory allocated once the index was ready, GiB (the allocator's
count, read by the benchmark): what the served index keeps on the card.
The Reader's peak less this is the load's scratch."""

UNIT = 'GiB'


def read(ctx):
    if ctx.index_resident_bytes is None:
        return None
    return ctx.index_resident_bytes / 2**30
