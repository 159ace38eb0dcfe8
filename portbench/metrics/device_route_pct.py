"""Share of the window's batches in which the probe kernel (K4,
``ops/kernels.LAUNCHES['probe_phased']``) launched: the batches the
Reader's routing sent to the card."""

UNIT = '%'


def read(ctx):
    if ctx.batches == 0:
        return None
    return 100.0 * ctx.device_route_batches / ctx.batches
