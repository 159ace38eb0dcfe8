"""``HostServing``'s line fan-out per (pattern, line) pair it made: the
``hs-fanout`` span's seconds over the ``hs-lines`` counter of the window,
in ns; none where the program has no such counter or made no line."""

UNIT = 'ns/line'


def read(ctx):
    seconds, count = ctx.phase('hs-fanout')
    _, lines = ctx.phase('hs-lines')
    if count == 0 or lines == 0:
        return None
    return seconds / lines * 1e9
