"""The port's multi-process path on the CPU: two worker processes that
import only the port join a gloo group through ``file://`` (no TCP port),
run the host gathers, the chunk-parallel probe and full step, and the
MultiHostReader end to end.  The parent holds their output to the JAX
package's world-1 answers and to a Python ground truth.  Every spawn has
its own timeout."""

import collections
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pysubstringsearch_tpu.ops import search as jsearch
from pysubstringsearch_tpu.ops.suffix_array import _pad_len, suffix_array_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r'''
import json, os, sys
import numpy as np
import torch
rank, tmp = int(sys.argv[1]), sys.argv[2]
from pysubstringsearch_tpu_torch.parallel import multihost
multihost.initialize('file://' + os.path.join(tmp, 'rendezvous'), 2, rank,
                     'gloo')
'''

PROGRAMS_WORKER = _PRELUDE + r'''
from pysubstringsearch_tpu_torch.parallel import mesh as mesh_lib, sharded
inp = np.load(os.path.join(tmp, 'inputs.npz'))
mesh = mesh_lib.make_mesh('cpu')
assert (mesh.rank, mesh.world, mesh.distributed) == (rank, 2, True)
assert multihost.my_chunk_ids(5) == [c for c in range(5) if c % 2 == rank]
blobs = multihost.allgather_bytes(b'rank %d ' % rank * (3 + 5 * rank))
assert blobs == [b'rank 0 ' * 3, b'rank 1 ' * 8], blobs
counts = multihost.allgather_counts(np.full((2, 3), rank, np.int32))
assert counts.shape == (2, 2, 3) and counts[1].min() == 1
args = (inp['text'], inp['n'], inp['sa'], inp['patterns'], inp['lengths'])
gathered = sharded.make_sharded_probe(mesh)(*args)
local = sharded.make_sharded_probe(mesh, gather=False)(*args)
bounds, totals = sharded.make_full_step(mesh)(
    inp['text'], inp['n'], inp['patterns'], inp['lengths'])
sa_local = sharded.make_sharded_build(mesh)(inp['text'], inp['n'])
np.savez(os.path.join(tmp, f'out{rank}.npz'), gathered=gathered.numpy(),
         local=local.numpy(), bounds=bounds.numpy(), totals=totals.numpy(),
         sa_local=sa_local.numpy())
assert 'jax' not in sys.modules and 'pysubstringsearch_tpu' not in sys.modules
print(f'WORKER{rank}_OK', flush=True)
'''

READER_WORKER = _PRELUDE + r'''
from pysubstringsearch_tpu_torch.parallel import manifest
spec = json.load(open(os.path.join(tmp, 'spec.json')))
d = os.path.join(tmp, 'mh-index')
if rank == 0:
    with manifest.ShardedWriter(d, num_shards=2, max_chunk_len=16384) as w:
        for ln in spec['lines']:
            w.add_entry(ln)
    open(os.path.join(tmp, 'ready'), 'w').write('1')
else:
    import time
    while not os.path.exists(os.path.join(tmp, 'ready')):
        time.sleep(0.1)
r = multihost.MultiHostReader(d, device='cpu')
per = [r.search(p) for p in spec['patterns']]
multi = r.search_multiple(spec['patterns'])
json.dump({'per': per, 'multi': multi,
           'local_shards': [os.path.basename(p) for p in
                            manifest.local_shard_paths(d)]},
          open(os.path.join(tmp, f'result{rank}.json'), 'w'))
print(f'WORKER{rank}_OK', flush=True)
'''


def _run_workers(tmp_path, script: str, timeout: int = 240):
    script_path = tmp_path / 'worker.py'
    script_path.write_text(script)
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    procs = [
        subprocess.Popen(
            [sys.executable, str(script_path), str(rank), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail('a worker process timed out')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {rank} failed:\n{out}'
        assert f'WORKER{rank}_OK' in out


def _inputs():
    rng = np.random.default_rng(3)
    words = [b'alpha', b'beta', b'gamma', b'delta', b'zeta']
    raw = []
    for c in range(6):
        lines = [b' '.join(words[i] for i in rng.choice(5, size=3))
                 for _ in range(int(rng.integers(5, 40)))]
        raw.append(b'\n'.join(lines) + b'\n')
    raw += [b'', b'gamma\n']  # an empty row, 8 rows in all
    N = _pad_len(max(map(len, raw)) + 1024)
    text = np.zeros((len(raw), N), np.uint8)
    sa = np.zeros((len(raw), N), np.int32)
    n = np.array([len(c) for c in raw], np.int32)
    for i, c in enumerate(raw):
        data = np.frombuffer(c, np.uint8)
        text[i, : data.size] = data
        sa[i, : data.size] = suffix_array_numpy(data)
    pats = [b'alpha', b'beta gamma', b'zeta\n', b'', b'q', b'a']
    patterns, lengths = jsearch.pack_patterns(pats)
    return raw, text, n, sa, patterns, lengths


def test_two_ranks_gather_what_one_rank_computes(tmp_path):
    """allgather_bytes and allgather_counts across two gloo ranks; the
    gathered probe and full step equal, on both ranks, the world-1 answer
    of the JAX probe row by row; the ungathered probe and the build give
    each rank its own block."""
    raw, text, n, sa, patterns, lengths = _inputs()
    np.savez(tmp_path / 'inputs.npz', text=text, n=n, sa=sa,
             patterns=patterns, lengths=lengths)
    _run_workers(tmp_path, PROGRAMS_WORKER)
    want = np.stack([
        np.stack([np.asarray(a) for a in jsearch.probe_bounds_loop(
            jnp.asarray(text[i]), int(n[i]), jnp.asarray(sa[i]),
            jnp.asarray(patterns), jnp.asarray(lengths))], -1)
        for i in range(len(raw))
    ])
    totals = want[..., 1].sum(0)
    assert totals[0] == sum(c.count(b'alpha') for c in raw)
    C = len(raw)
    for rank in range(2):
        out = np.load(tmp_path / f'out{rank}.npz')
        np.testing.assert_array_equal(out['gathered'], want)
        np.testing.assert_array_equal(out['bounds'], want)
        np.testing.assert_array_equal(out['totals'], totals)
        block = slice(rank * C // 2, (rank + 1) * C // 2)
        np.testing.assert_array_equal(out['local'], want[block])
        for j, i in enumerate(range(C)[block]):
            np.testing.assert_array_equal(out['sa_local'][j, : n[i]],
                                          sa[i, : n[i]])


def test_multihost_reader_end_to_end(tmp_path):
    """MultiHostReader over a ShardedWriter index: each rank loads only its
    own shard, and both return the ground truth's multisets."""
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 105, size=int(l), dtype=np.uint8))
             .decode() for l in rng.integers(3, 8, size=60)]
    lines = [' '.join(words[i] for i in rng.integers(0, 60, size=5))
             for _ in range(3000)]
    pats = [words[0], words[1][:3], 'zzzz', words[2] + ' ' + words[3], '']
    (tmp_path / 'spec.json').write_text(
        json.dumps({'lines': lines, 'patterns': pats}))
    _run_workers(tmp_path, READER_WORKER)
    for rank in range(2):
        res = json.loads((tmp_path / f'result{rank}.json').read_text())
        assert res['local_shards'] == [f'shard-000{rank}.idx']
        for p, got in zip(pats, res['per']):
            want = collections.Counter(ln for ln in lines if p in ln)
            assert collections.Counter(got) == want, p
        assert collections.Counter(res['multi']) == collections.Counter(
            ln for p in pats for ln in lines if p in ln)
