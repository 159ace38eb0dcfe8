"""The PyTorch port runs where JAX is not installed: importing it loads
neither jax nor the JAX package, and no source of it imports either."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'pysubstringsearch_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'pysubstringsearch_tpu')


def _sources():
    out = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith('.py')]
    return sorted(out)


def test_import_loads_no_jax():
    code = (
        'import json, sys; before = set(sys.modules); '
        'import pysubstringsearch_tpu_torch, '
        'pysubstringsearch_tpu_torch.ops.kernels, '
        'pysubstringsearch_tpu_torch.ops.bwt, '
        'pysubstringsearch_tpu_torch.parallel.sharded, '
        'pysubstringsearch_tpu_torch.parallel.multihost, '
        'pysubstringsearch_tpu_torch.parallel.reader, '
        'pysubstringsearch_tpu_torch.parallel.manifest, '
        'pysubstringsearch_tpu_torch.__main__; '
        'print(json.dumps(sorted(set(sys.modules) - before)))'
    )
    proc = subprocess.run(
        [sys.executable, '-c', code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert 'pysubstringsearch_tpu_torch.api' in loaded
    assert 'pysubstringsearch_tpu_torch.parallel.multihost' in loaded
    bad = [m for m in loaded if m.split('.')[0] in FORBIDDEN]
    assert not bad


@pytest.mark.parametrize(
    'path', _sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in FORBIDDEN, (path, name)
