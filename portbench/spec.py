"""Finding a cell's files by name.

- a cell: ``workloads/<cell>.json`` (its configuration, traffic mix and
  chips, and how many batches it warms and checks);
- a configuration: ``configs/<config>.json`` (its corpus, the Writer's
  settings, the guarantee the answers are held to, its source);
- a traffic mix: ``traffic/<mix>.json`` (read by ``traffic.py``);
- a per-layer metric: ``metrics/<metric>.py``, a module with ``UNIT`` and
  ``read(ctx)``, which returns the metric's value or None where the run
  gave it nothing to read.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import types
import typing

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str, name: str, root: str = HERE) -> typing.Dict[str, typing.Any]:
    """The JSON file ``<kind>/<name>.json`` under ``root`` (the
    benchmark's folder)."""
    if '/' in name or name.startswith('.'):
        raise ValueError(f'bad {kind} name: {name!r}')
    path = os.path.join(root, kind, name + '.json')
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: str = HERE) -> typing.Tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of the workload ``name``."""
    c = load('workloads', name, root)
    return (c, load('configs', c['config'], root),
            load('traffic', c['traffic'], root))


def readers(root: str = HERE) -> typing.Dict[str, types.ModuleType]:
    """Every per-layer metric's reader, by metric name."""
    directory = os.path.join(root, 'metrics')
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, '*.py'))):
        name = os.path.basename(path)[:-len('.py')]
        if name.startswith('_'):
            continue
        spec = importlib.util.spec_from_file_location(
            f'portbench_metric_{name}', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out[name] = module
    return out
