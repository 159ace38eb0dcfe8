"""The readers of the search path's spans and counters: each returns its
metric from a run's context, and nothing where the program has no such
span or counter (a checkout that predates them)."""

import pytest

from portbench import run, spec


def _context(**kw):
    base = dict(batches=4, phases={}, load_phases={}, device_route_batches=4,
                batch_walls=[0.02] * 4, ready_s=4.0, writer_s=5.0,
                corpus_bytes=10**6, probe_bytes=0, device_name='cpu')
    return run.Context(**dict(base, **kw))


#: Phases of a window of 4 batches: (seconds, count).
PHASES = {
    'batch': (0.100, 4), 'encode': (0.002, 4), 'dedup': (0.003, 4),
    'route': (0.001, 4), 'pack': (0.040, 4), 'probe': (0.008, 4),
    'probe-upload': (0.002, 4), 'probe-kernel': (0.0004, 4),
    'probe-readback': (0.004, 4), 'probe-nul': (0.0032, 4),
    'extract': (0.040, 4), 'flatten': (0.001, 4),
    'hs-fanout': (0.030, 4), 'hs-lines': (0.0, 20000),
}
#: The phases of a checkout without the new spans.
OLD = {k: PHASES[k] for k in ('probe', 'extract', 'hs-fanout')}


@pytest.mark.parametrize('name,phases,value', [
    ('pack_ms', PHASES, 10.0),
    ('pack_ms', OLD, None),
    ('probe_upload_ms', PHASES, 0.5),
    ('probe_upload_ms', OLD, None),
    ('probe_readback_ms', PHASES, 1.0),
    ('probe_readback_ms', OLD, None),
    ('probe_nul_ms', PHASES, 0.8),
    ('probe_nul_ms', {k: v for k, v in PHASES.items() if k != 'probe-nul'},
     None),
    ('fanout_ns_per_line', PHASES, 1500.0),
    ('fanout_ns_per_line', OLD, None),
    ('batch_unattributed_pct', PHASES, 5.0),
    ('batch_unattributed_pct', OLD, None),
])
def test_span_reader_reads_its_context(name, phases, value):
    got = spec.readers()[name].read(_context(phases=phases))
    if value is None:
        assert got is None
    else:
        assert got == pytest.approx(value)


def test_unattributed_counts_only_direct_children():
    """The probe's sub-spans nest in ``probe`` and the ``hs-*`` ones in
    ``extract``: adding them changes nothing."""
    read = spec.readers()['batch_unattributed_pct'].read
    inner = {k: v for k, v in PHASES.items()
             if not k.startswith(('probe-', 'hs-'))}
    assert read(_context(phases=inner)) == pytest.approx(
        read(_context(phases=PHASES)))
