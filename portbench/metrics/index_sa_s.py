"""The device index's SA derive (``index-sa`` phase: B10 for a 512 MiB
row, B9 after a poisoned one), seconds."""

UNIT = 's'


def read(ctx):
    seconds, count = ctx.load_phases.get('index-sa', (0.0, 0))
    if count == 0:
        return None
    return seconds
