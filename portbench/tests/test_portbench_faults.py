"""The harness run end to end on the CPU at a small size (the program's
plain kernels; the look for a card skipped), sound and with the timed
path broken underneath: each fault that a cell can have, and the control
in the program's place, makes ``correct`` false.

One card holds each cell, so no exchange between chips can be left out.
"""

import json

import pytest

import pysubstringsearch_tpu_torch as pss
from portbench import reference, run, spec

SEED = 2**31 + 4242


def small_run(name, monkeypatch, seconds=1.0):
    monkeypatch.setenv('TPUSS_BG_LOAD', '1')  # the card's route: load on a thread
    cell, config, mix = spec.cell(name)
    config = dict(config, corpus=dict(config['corpus'],
                                      target_bytes=1_000_000))
    # Every cycle entry once a cycle, so a short window holds each route.
    mix = dict(mix, pool_cycles=2, cycle=[
        dict(e, batch=min(e['batch'], 128), batches=1) for e in mix['cycle']])
    cell = dict(cell, check_batches=2)
    return run.run(name, SEED, seconds, False, cell=cell, config=config,
                   mix=mix, device='cpu')


@pytest.mark.parametrize('name', ['ranked-500mb.selective',
                                  'ranked-500mb.broad',
                                  'raw-500mb.selective'])
def test_sound_run_is_correct(name, monkeypatch):
    result, lines = small_run(name, monkeypatch)
    assert result['correct'] is True, lines
    assert set(result) == {'correct', 'attempted', 'failed', 'metrics',
                           'device', 'card', 'window', 'check'}
    assert list(result)[-1] == 'check'
    # A CPU run names the CPU and reports no device reading: of the
    # end-to-end metrics only the set-up, and the window's work.
    assert set(result['metrics']) == {'setup_s'}
    assert result['metrics']['setup_s']['value'] > 0
    assert result['window']['patterns'] > 0
    assert result['device']['platform'] == 'cpu'
    assert result['device']['memory_peak_bytes'] is None
    # Two batches of each cycle entry checked, each of at most 128.
    cycle = spec.cell(name)[2]['cycle']
    least = 2 * sum(min(e['batch'], 128) for e in cycle)
    assert result['check']['patterns_checked']['limit'] == least
    assert len(lines) == len(result['check'])
    json.dumps(result)


def stale(orig):
    """A step that returns its state unchanged: every batch gets the first
    batch's answer."""
    state = {}

    def search_multiple(self, subs):
        if 'answer' not in state:
            state['answer'] = orig(self, subs)
        return state['answer']
    return search_multiple


def half(orig):
    """Half of the batch left out."""
    def search_multiple(self, subs):
        return orig(self, subs[: len(subs) // 2])
    return search_multiple


def altered(orig):
    """An answer altered where it is produced: one line of each batch's
    answer has its first character changed."""
    def search_multiple(self, subs):
        out = list(orig(self, subs))
        if out:
            out[0] = ('#' if out[0][:1] != '#' else '%') + out[0][1:]
        return out
    return search_multiple


def control(orig):
    """The control: the plain reference in the program's place, with its
    exactness given up (a candidate accepted on its first KEY_BYTES
    bytes)."""
    def search_multiple(self, subs):
        import numpy as np

        data = np.array(self._chunks[0].data)
        newlines = np.flatnonzero(data == ord('\n'))
        ids = reference.find_lines(data, newlines,
                                   [s.encode() for s in subs],
                                   device='cpu', whole_pattern=False)
        return [line for i in ids
                for line in reference.line_strings(data, newlines, i)]
    return search_multiple


@pytest.mark.parametrize('fault', [stale, half, altered, control],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize('name', ['ranked-500mb.selective',
                                  'ranked-500mb.broad',
                                  'raw-500mb.selective'])
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    monkeypatch.setattr(pss.Reader, 'search_multiple',
                        fault(pss.Reader.search_multiple))
    # The control answers a batch in about a second on the CPU: a window
    # long enough for a batch of each cycle entry.
    result, lines = small_run(name, monkeypatch, seconds=4.0)
    assert result['correct'] is False, lines
    bad = [k for k, v in result['check'].items()
           if (v['value'] > v['limit'] if v['side'] == 'max'
               else v['value'] < v['limit'])]
    # A departure in the answers fails the run, not a short window.
    assert set(bad) - {'patterns_checked'}, bad


@pytest.mark.parametrize('name', ['ranked-500mb.selective',
                                  'ranked-500mb.broad',
                                  'raw-500mb.selective'])
def test_control_script_comes_out_not_correct(name):
    """``portbench.control`` at a small size: the control fails the run's
    comparison on the batches a run checks."""
    from portbench import check, control

    cell, config, mix = spec.cell(name)
    config = dict(config, corpus=dict(config['corpus'],
                                      target_bytes=1_000_000))
    mix = dict(mix, pool_cycles=2)
    numbers = control.control_numbers(cell, config, mix, SEED, device='cpu')
    lims = check.limits(1, mix)
    assert not check.verdict(numbers, lims), numbers
    assert numbers['extra_lines'] > 0
