"""Share of the Reader's ``batch`` spans (all of ``search_multiple``) that
none of its direct child spans holds: the host work in a batch that the
program leaves unnamed.  None where the program has no ``batch`` span."""

UNIT = '%'

#: The spans that ``api.Reader`` opens directly inside ``batch``.
CHILDREN = ('encode', 'dedup', 'route', 'pack', 'probe', 'extract',
            'flatten', 'host-serve', 'host-route')


def read(ctx):
    batch, count = ctx.phase('batch')
    if count == 0 or batch <= 0:
        return None
    children = sum(ctx.phase(name)[0] for name in CHILDREN)
    return 100.0 * (batch - children) / batch
