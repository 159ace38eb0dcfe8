"""The port's DeviceIndex against the JAX package's upload-mode index on the
CPU: the arrays it builds, state carried over with ``from_arrays``, and the
probe's answers for one batch."""

import numpy as np
import pytest
import torch

from pysubstringsearch_tpu.container import Chunk as JChunk
from pysubstringsearch_tpu.models.index import DeviceIndex as JIndex
from pysubstringsearch_tpu.ops.suffix_array import suffix_array_numpy
from pysubstringsearch_tpu_torch.container import Chunk
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops import search as tsearch

torch.set_num_threads(1)


def _chunks(kind: str):
    rng = np.random.default_rng(len(kind))
    out = []
    for m in (2500, 1800, 3100):
        if kind == 'ranked':
            body = rng.integers(97, 123, size=m, dtype=np.uint8)
        elif kind == 'ranked6':
            body = rng.integers(60, 115, size=m, dtype=np.uint8)
        else:  # raw: a large NUL-free alphabet
            body = rng.integers(1, 256, size=m, dtype=np.uint8)
        body[::41] = 0x0A
        body[-1] = 0x0A
        out.append(body)
    return out


def _patterns(bodies):
    rng = np.random.default_rng(5)
    pats = [b'', b'a', b'\n', b'\x00', b'q\x00z', b'zzzzzzzz', b'\xfe\xfe']
    for _ in range(60):
        body = bodies[int(rng.integers(0, len(bodies)))]
        l = int(rng.integers(1, 40))
        i = int(rng.integers(0, body.size - l))
        pats.append(body[i: i + l].tobytes())
    return pats


def _jax_index(bodies):
    return JIndex(
        [JChunk(data=b, suffix_array=suffix_array_numpy(b)) for b in bodies],
        mode='upload',
    )


def _port_index(bodies):
    return DeviceIndex(
        [Chunk(data=b, suffix_array=suffix_array_numpy(b)) for b in bodies],
        device='cpu',
    )


@pytest.mark.parametrize('kind', ['ranked', 'ranked6', 'raw'])
def test_index_arrays_equal_jax(kind):
    bodies = _chunks(kind)
    j, t = _jax_index(bodies), _port_index(bodies)
    assert (t.kind, t._bits, t._base, t._depth, t.num_limbs, t.n_pad) == (
        j.kind, j._bits, j._base, j._depth, j.num_limbs, j.n_pad
    )
    for name in ('text', 'lengths', 'sa', 'tables', 'limbs', 'rank',
                 'present'):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)), name
        )


@pytest.mark.parametrize('kind', ['ranked', 'raw'])
def test_from_arrays_carry_over(kind):
    bodies = _chunks(kind)
    j = _jax_index(bodies)
    arrays = {name: np.asarray(getattr(j, name)) for name in (
        'text', 'lengths', 'sa', 'tables', 'limbs', 'rank', 'present')}
    meta = dict(kind=j.kind, bits=j._bits, base=j._base, depth=j._depth,
                num_limbs=j.num_limbs)
    t = DeviceIndex.from_arrays(arrays, meta, 'cpu')
    assert t.num_chunks == j.num_chunks and not t.merged
    packed, lengths = tsearch.pack_patterns(_patterns(bodies))
    lo_j, cnt_j = j.probe(packed, lengths)
    lo_t, cnt_t = t.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    hit = cnt_j > 0
    np.testing.assert_array_equal(lo_t[hit], lo_j[hit])
    np.testing.assert_array_equal(t.count_matches(packed, lengths), cnt_j)


def test_probe_edge_shapes():
    bodies = _chunks('ranked')
    t = _port_index(bodies)
    wide = np.zeros((2, t.n_pad + 8), dtype=np.uint8)
    lo, cnt = t.probe(wide, np.array([1, t.n_pad + 8], dtype=np.int32))
    assert lo.shape == cnt.shape == (3, 2) and not cnt.any()
    lo, cnt = t.probe(np.zeros((0, 8), np.uint8), np.zeros(0, np.int32))
    assert cnt.shape == (3, 0)
    empty = DeviceIndex([], device='cpu')
    assert empty.probe(*tsearch.pack_patterns([b'a']))[1].shape == (0, 1)


def test_unported_modes_raise():
    """Every alphabet kind builds in every mode; only a mode the index does
    not know raises."""
    rng = np.random.default_rng(0)
    body = rng.integers(0, 256, size=3000, dtype=np.uint8)  # NUL, big sigma
    chunk = Chunk(data=body, suffix_array=suffix_array_numpy(body))
    # The digit kind (NUL in a wide alphabet) builds in every mode now.
    for mode, built in (('auto', 'upload'), ('upload', 'upload'),
                        ('derive', 'derive')):
        idx = DeviceIndex([chunk], device='cpu', mode=mode)
        assert idx.kind == 'digit' and idx.mode == built
        np.testing.assert_array_equal(idx.sa[0, : body.size].numpy(),
                                      chunk.suffix_array)
    # The raw kind (NUL-free) derives now.
    raw = np.where(body == 0, 1, body).astype(np.uint8)
    raw_chunk = Chunk(data=raw, suffix_array=suffix_array_numpy(raw))
    idx = DeviceIndex([raw_chunk], device='cpu', mode='derive')
    assert idx.kind == 'raw' and idx.mode == 'derive'
    np.testing.assert_array_equal(idx.sa[0, : raw.size].numpy(),
                                  raw_chunk.suffix_array)
    with pytest.raises(ValueError):
        DeviceIndex([chunk], device='cpu', mode='sideways')


@pytest.mark.parametrize('kind', ['ranked', 'raw'])
def test_build_phases_recorded(kind):
    from pysubstringsearch_tpu_torch.utils.profiling import PhaseProfiler

    bodies = _chunks(kind)
    prof = PhaseProfiler()
    DeviceIndex(
        [Chunk(data=b, suffix_array=suffix_array_numpy(b)) for b in bodies],
        device='cpu', profiler=prof,
    )
    assert dict(prof.counts) == {
        'index-alphabet': 1, 'index-alloc': 1,
        'index-host-copy': len(bodies), 'index-h2d': len(bodies),
        'index-aux': 1,
    }
