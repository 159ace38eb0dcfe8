"""The Writer at its defaults: corpus MB (10^6 bytes) over its wall, from
the first line read to the container closed."""

UNIT = 'MB/s'


def read(ctx):
    return ctx.corpus_bytes / 1e6 / ctx.writer_s
