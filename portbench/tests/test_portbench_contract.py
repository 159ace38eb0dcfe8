"""BENCHMARK.json and the harness's files agree; the result line has the
contract's keys; new configurations, mixes and metrics are found by
name; nothing the benchmark runs imports JAX or the JAX package; and a
run without a card fails before it reports anything."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pysubstringsearch_tpu')
PROGRAM = 'pysubstringsearch_tpu_torch'
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def benchmark():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        return json.load(f)


def sources():
    out = []
    for root, _, files in os.walk(BENCH):
        out += [os.path.join(root, f) for f in files if f.endswith('.py')]
    return sorted(out)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or '')
    return {n.split('.')[0] for n in names}


def test_benchmark_json_shape():
    b = benchmark()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['paths'] == ['portbench'] and 1 <= b['run_seconds'] <= 51
    assert len(json.dumps(b)) < 64 << 10
    names = [m['name'] for m in b['end_to_end'] + b['per_layer']]
    names += [w['name'] for w in b['workloads']]
    names += [c['name'] for c in b['configs']]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m['name'] for m in b['end_to_end']}
    assert 'setup_s' in e2e
    for m in b['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    readers = spec.readers()
    cells = {w['name'] for w in b['workloads']}
    for m in b['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e
        assert set(m.get('workloads', cells)) <= cells
        assert readers[m['name']].UNIT == m['unit']
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'
    assert set(readers) == {m['name'] for m in b['per_layer']}
    for c in b['configs']:
        assert c['file'] == f'portbench/configs/{c["name"]}.json'
        assert spec.load('configs', c['name'])['reduced'] == c['reduced']
        assert spec.load('configs', c['name'])['source'] == c['source']
    for w in b['workloads']:
        cell, _, _ = spec.cell(w['name'])
        assert (cell['config'], cell['traffic'], cell['chips']) == (
            w['config'], w['traffic'], w['chips'])
        assert w['chips'] == 1 and len(w['why']) <= 200


def test_cells_check_every_cycle_entry():
    """A run's floor of patterns checked follows from the batches of each
    cycle entry it checks and their sizes."""
    from portbench import check

    floors = {}
    for name in ('ranked-500mb.selective', 'ranked-500mb.broad',
                 'raw-500mb.selective'):
        cell, _, mix = spec.cell(name)
        floors[name] = check.limits(cell['check_batches'], mix)[
            'patterns_checked']
    assert floors == {'ranked-500mb.selective': ('min', 16 * 4096),
                      'ranked-500mb.broad': ('min', 4 * (16 + 1024)),
                      'raw-500mb.selective': ('min', 16 * 4096)}


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, mix, cell and metric added as files, and nothing
    else, are found by their names."""
    root = tmp_path / 'bench'
    shutil.copytree(BENCH, root,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    (root / 'configs' / 'tiny.json').write_text(json.dumps(
        dict(spec.load('configs', 'ranked-500mb'), name='tiny')))
    (root / 'traffic' / 'single.json').write_text(json.dumps({
        'pool_cycles': 4,
        'cycle': [{'batches': 1, 'batch': 1, 'sources': [
            {'kind': 'word', 'share': 1.0, 'zipf': 0.99}]}]}))
    (root / 'workloads' / 'tiny.single.json').write_text(json.dumps({
        'config': 'tiny', 'traffic': 'single', 'chips': 1,
        'check_batches': 1}))
    (root / 'metrics' / 'batches_seen.py').write_text(
        'UNIT = "batches"\n\n\ndef read(ctx):\n    return ctx.batches\n')
    cell, config, mix = spec.cell('tiny.single', str(root))
    assert config['name'] == 'tiny' and mix['cycle'][0]['batch'] == 1
    assert cell['traffic'] == 'single'
    readers = spec.readers(str(root))
    assert 'batches_seen' in readers and 'probe_ms' in readers


def _context(**kw):
    from portbench import run

    base = dict(batches=4, phases={}, load_phases={}, device_route_batches=4,
                batch_walls=[0.02] * 4, ready_s=4.0, writer_s=5.0,
                corpus_bytes=10**6, probe_bytes=0, device_name='cpu')
    return run.Context(**dict(base, **kw))


@pytest.mark.parametrize('name,kw,value', [
    ('search_patterns_per_s', dict(patterns=8192, window_s=0.5), 16384.0),
    ('search_patterns_per_s', dict(batches=0, patterns=0, window_s=0.5),
     None),
    ('index_resident_gib', dict(index_resident_bytes=3 << 30), 3.0),
    ('index_resident_gib', {}, None),
])
def test_reader_reads_its_context(name, kw, value):
    """A reader returns its metric from the run's context, and nothing
    where the run gave it nothing to read."""
    assert spec.readers()[name].read(_context(**kw)) == value


@pytest.mark.parametrize('path', sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax(path):
    bad = imported(path) & set(FORBIDDEN)
    assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for name in ('reference.py', 'check.py', 'roofline.py', 'corpus.py',
                 'traffic.py'):
        assert PROGRAM not in imported(os.path.join(BENCH, name)), name


def test_run_loads_no_jax():
    """Importing the harness and the program it drives loads no module
    whose top-level name is JAX's or the JAX package's, compared whole."""
    code = (
        'import json, sys; import portbench.run, portbench.devtrace, '
        'portbench.check, pysubstringsearch_tpu_torch, '
        'pysubstringsearch_tpu_torch.ops.kernels; '
        'print(json.dumps(sorted(sys.modules)))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert PROGRAM in loaded
    assert not [m for m in loaded if m.split('.')[0] in FORBIDDEN]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, 'jaxlike_module', sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'pysubstringsearch_tpu.api', sys)
    assert run.forbidden_modules() == ['pysubstringsearch_tpu.api']


def test_run_without_a_card_fails(monkeypatch, capsys):
    """No CUDA device: the run exits non-zero and prints no result."""
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = run.main(['--workload', 'ranked-500mb.selective', '--seed', '1',
                   '--seconds', '1', '--trace', '0'])
    assert rc != 0
    assert capsys.readouterr().out == ''


def test_run_without_the_program_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints nothing on standard output."""
    shutil.copytree(BENCH, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), tmp_path)
    proc = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'ranked-500mb.selective', '--seed', '3', '--seconds', '1',
         '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ''


@pytest.mark.cuda
def test_card_run_reports_the_card():
    """On a card: one short run of the ranked selective cell prints the
    contract's last line, correct, with the card's name."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'ranked-500mb.selective', '--seed', '2147483659', '--seconds', '2',
         '--trace', '0'],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line['correct'] is True
    assert line['device']['kind'] == torch.cuda.get_device_name(0)
    assert list(line)[-1] == 'check'
