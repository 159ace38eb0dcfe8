"""The port's CLI (``python -m pysubstringsearch_tpu_torch``) on the CPU:
the build / search / shard round trip of ``tests/test_cli.py`` with
``--device cpu``, and an index written by the JAX package's CLI, sharded by
the port's and read back by both packages."""

import collections
import contextlib
import io
import os
import subprocess
import sys

import pytest

from pysubstringsearch_tpu.__main__ import main as jmain
from pysubstringsearch_tpu.parallel import manifest as jmanifest
from pysubstringsearch_tpu_torch.__main__ import main
from pysubstringsearch_tpu_torch.parallel import manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_cli_roundtrip(tmp_path):
    corpus = tmp_path / 'corpus.txt'
    corpus.write_text('red apple\ngreen pear\nred rose\n')
    idx = str(tmp_path / 'c.idx')
    assert main(['build', str(corpus), idx, '--chunk-mb', '1',
                 '--sa-backend', 'numpy']) == 0
    assert _run(['search', idx, 'red', '--count-only',
                 '--device', 'cpu']).strip() == 'red\t2'
    assert _run(['search', idx, 'pear', '--device', 'cpu']).strip() == \
        'green pear'
    shard_dir = str(tmp_path / 'shards')
    assert main(['shard', idx, shard_dir, '--shards', '2']) == 0
    r = manifest.open_local_reader(shard_dir, device='cpu')
    assert sorted(r.search('red')) == ['red apple', 'red rose']


def test_cli_rejects_the_jax_backend_name(tmp_path):
    with pytest.raises(SystemExit):
        main(['build', str(tmp_path / 'x.txt'), str(tmp_path / 'x.idx'),
              '--sa-backend', 'jax'])


def test_jax_index_sharded_by_the_port(tmp_path):
    """A JAX-written index, sharded by the port's CLI: the manifest is the
    JAX ``convert_index``'s byte for byte, and both packages read it."""
    lines = [f'line {i} of {"abc"[i % 3]} words' for i in range(400)]
    corpus = tmp_path / 'corpus.txt'
    corpus.write_text('\n'.join(lines) + '\n')
    idx = str(tmp_path / 'j.idx')
    assert jmain(['build', str(corpus), idx, '--chunk-mb', '1',
                  '--sa-backend', 'numpy']) == 0
    ours, theirs = str(tmp_path / 'ours'), str(tmp_path / 'theirs')
    assert main(['shard', idx, ours, '--shards', '3']) == 0
    jmanifest.convert_index(idx, theirs, 3)
    for name in sorted(os.listdir(theirs)):
        with open(os.path.join(ours, name), 'rb') as a, \
                open(os.path.join(theirs, name), 'rb') as b:
            assert a.read() == b.read(), name
    r = manifest.open_local_reader(ours, device='cpu')
    jr = jmanifest.open_local_reader(ours)
    for pat in ['of b', 'line 1', 'words', 'zz']:
        want = collections.Counter(ln for ln in lines if pat in ln)
        assert collections.Counter(r.search(pat)) == want, pat
        assert collections.Counter(jr.search(pat)) == want, pat
    assert _run(['search', idx, 'of c', '--count-only', '--device',
                 'cpu']).strip() == f'of c\t{sum("of c" in l for l in lines)}'


def test_module_entry_point(tmp_path):
    """``python -m pysubstringsearch_tpu_torch`` runs the CLI."""
    corpus = tmp_path / 'corpus.txt'
    corpus.write_text('alpha\nbeta\nalphabet\n')
    idx = str(tmp_path / 'm.idx')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    for argv in (['build', str(corpus), idx, '--sa-backend', 'numpy'],
                 ['search', idx, 'alpha', '--count-only', '--device', 'cpu']):
        proc = subprocess.run(
            [sys.executable, '-m', 'pysubstringsearch_tpu_torch', *argv],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
        assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'alpha\t2'
