"""The 95th percentile of the window's ``search_multiple`` walls, ms (host
clock, with the trace on): a batch's tail, kept beside the end-to-end
rate because one batch is shorter than a host-clock reading can bound."""

import statistics

UNIT = 'ms'


def read(ctx):
    if len(ctx.batch_walls) < 20:
        return None
    return statistics.quantiles(ctx.batch_walls, n=20)[-1] * 1e3
