"""``Reader(path)`` to ``wait_device_ready()`` True, seconds (host clock):
the container's map, the alphabet scan, the upload, the SA's derive on
the card, the limb planes and tables, the warm probe."""

UNIT = 's'


def read(ctx):
    return ctx.ready_s
