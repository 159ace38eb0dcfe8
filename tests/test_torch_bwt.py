"""The port's ``ops/bwt.py`` against the JAX package's on the CPU: the
forward transform (host and B13's plain version), its inverse, the
sampled-index forms, and the validation of each, on the cases of
``tests/test_bwt.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysubstringsearch_tpu.ops import bwt as J
from pysubstringsearch_tpu_torch.ops import bwt as T
from pysubstringsearch_tpu_torch.ops import native
from pysubstringsearch_tpu_torch.ops.suffix_array import suffix_array_numpy

torch.set_num_threads(1)

CASES = [
    b'',
    b'a',
    b'aa',
    b'ab',
    b'banana',
    b'mississippi',
    b'abcabcabc',
    b'one\ntwo\nthree\n',
    b'\x00\x00\x01\x00',
    bytes(range(256)) * 3,
]


def _arr(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


@pytest.mark.parametrize('data', CASES, ids=range(len(CASES)))
def test_bwt_and_unbwt_match_jax(data):
    arr = _arr(data)
    u, p = T.bwt(arr)
    uj, pj = J.bwt(arr)
    assert bytes(u) == bytes(uj) and p == pj
    assert bytes(T.unbwt(u, p)) == data
    assert bytes(T._unbwt_numpy(u, p)) == bytes(J._unbwt_numpy(uj, pj))
    np.testing.assert_array_equal(T.byte_frequencies(arr),
                                  J.byte_frequencies(arr))


@pytest.mark.parametrize('data', CASES, ids=range(len(CASES)))
def test_bwt_from_sa_device_plain_matches_jax(data):
    """B13's plain version equals the JAX device function (and the host
    transform) bit for bit; n = 0 raises in both."""
    arr = _arr(data)
    sa = suffix_array_numpy(arr)
    if arr.size == 0:
        with pytest.raises(ValueError):
            J.bwt_from_sa_device(jnp.asarray(arr), jnp.asarray(sa))
        with pytest.raises(ValueError):
            T.bwt_from_sa_device(torch.from_numpy(arr.copy()),
                                 torch.from_numpy(sa))
        return
    uj, pj = J.bwt_from_sa_device(jnp.asarray(arr), jnp.asarray(sa))
    u, p = T.bwt_from_sa_device(torch.from_numpy(arr.copy()),
                                torch.from_numpy(sa))
    assert u.dtype == torch.uint8 and p.dtype == torch.int32 and p.dim() == 0
    assert bytes(u.numpy()) == bytes(np.asarray(uj)) and int(p) == int(pj)
    uh, ph = T.bwt_from_sa(arr, sa)
    assert bytes(uh) == bytes(u.numpy()) and ph == int(p)


def test_bwt_from_sa_device_random_matches_jax():
    rng = np.random.default_rng(3)
    for n in (2, 3, 17, 2048):
        arr = rng.integers(0, 256, size=n, dtype=np.uint8)
        sa = suffix_array_numpy(arr)
        uj, pj = J.bwt_from_sa_device(jnp.asarray(arr), jnp.asarray(sa))
        u, p = T.bwt_from_sa_device(torch.from_numpy(arr), torch.from_numpy(sa))
        assert bytes(u.numpy()) == bytes(np.asarray(uj)) and int(p) == int(pj)


@pytest.mark.parametrize('n', [1, 2, 17, 4099])
@pytest.mark.parametrize('where', ['first', 'last'])
def test_bwt_from_sa_device_primary_at_either_end(n, where):
    """B13's plain version (the wrapper's CPU path) equals the JAX device
    function and the host transform when the slot of suffix 0 is the
    first (i0 = 0) or the last (i0 = n - 1), on a permutation of [0, n) as
    the kernel takes it, at row lengths that are not multiples of 16."""
    rng = np.random.default_rng(n)
    arr = rng.integers(0, 256, size=n, dtype=np.uint8)
    sa = rng.permutation(n).astype(np.int32)
    i0 = 0 if where == 'first' else n - 1
    j = int(np.nonzero(sa == 0)[0][0])
    sa[j], sa[i0] = sa[i0], 0
    uj, pj = J.bwt_from_sa_device(jnp.asarray(arr), jnp.asarray(sa))
    u, p = T.bwt_from_sa_device(torch.from_numpy(arr), torch.from_numpy(sa))
    assert int(pj) == i0 + 1
    assert bytes(u.numpy()) == bytes(np.asarray(uj)) and int(p) == int(pj)
    uh, ph = T.bwt_from_sa(arr, sa)
    assert bytes(uh) == bytes(u.numpy()) and ph == int(p)


@pytest.mark.parametrize('data', CASES[1:], ids=range(len(CASES) - 1))
def test_bwt_aux_matches_jax(data):
    arr = _arr(data)
    for r in (2, 8, 64):
        u, I = T.bwt_aux(arr, r)
        uj, Ij = J.bwt_aux(arr, r)
        assert bytes(u) == bytes(uj)
        np.testing.assert_array_equal(I, Ij)
        assert bytes(T.unbwt_aux(u, r, I)) == data


def test_unbwt_native_matches_numpy():
    if not native.available():
        pytest.skip('no C++ compiler for the native kernels')
    rng = np.random.default_rng(11)
    arr = rng.integers(97, 123, size=5000, dtype=np.uint8)
    u, p = T.bwt(arr)
    assert native.unbwt_native(u, p).tobytes() == arr.tobytes()
    assert T._unbwt_numpy(u, p).tobytes() == arr.tobytes()
    with pytest.raises(RuntimeError):
        native.unbwt_native(u, 0)


def test_unbwt_aux_r_equals_n_is_plain_unbwt():
    rng = np.random.default_rng(17)
    arr = rng.integers(0, 256, size=4096, dtype=np.uint8)
    u, p = T.bwt(arr)
    out = T.unbwt_aux(u, arr.size, np.array([p], dtype=np.int32))
    np.testing.assert_array_equal(out, arr)


def test_validation_matches_jax():
    arr = _arr(b'banana')
    for mod in (T, J):
        with pytest.raises(ValueError):
            mod.bwt_aux(arr, 3)
        with pytest.raises(ValueError):
            mod.bwt_aux(arr, 1)
        u, I = mod.bwt_aux(arr, 2)
        with pytest.raises(ValueError):
            mod.unbwt_aux(u, 2, I[:1])
        bad = I.copy()
        bad[1] = 0
        with pytest.raises(ValueError):
            mod.unbwt_aux(u, 2, bad)
        with pytest.raises(ValueError):
            mod.unbwt(_arr(b'ab'), 0)
        with pytest.raises(ValueError):
            mod.unbwt(_arr(b'ab'), 3)
        u1, I1 = mod.bwt_aux(_arr(b'z'), 2)
        assert I1.tolist() == [1] and bytes(mod.unbwt_aux(u1, 2, I1)) == b'z'
        with pytest.raises(ValueError):
            mod.unbwt_aux(u1, 2, np.array([0], dtype=np.int32))
