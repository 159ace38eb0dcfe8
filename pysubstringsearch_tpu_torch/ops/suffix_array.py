"""Suffix-array construction, on the host and on the device.

Host: two backends, one contract (``uint8[n] -> int32[n]``), with the
ordering of the on-disk container: plain bytewise order where a proper
prefix sorts before any extension.

- ``native``: the C++ SA-IS kernel in ``native/sais.cpp`` (:mod:`.native`);
- ``numpy``: host prefix doubling, the ground truth for tests.

The SA of a string is unique, so every backend gives identical bytes.

Device (derive mode): :func:`derive_sa` builds a padded text row's SA by
tie-only prefix doubling, as the JAX package's ``derive_sa`` does: rows of
up to ``SEGMENTED_MAX_N`` padded slots by :func:`segmented_sa`
(``_segmented_kernel_ranked`` for ranked alphabets, ``_segmented_kernel``
for any other), longer ones by :func:`segmented_rotating_sa`, whose
poisoned rows the caller re-derives with :func:`derive_sa_full`.  All work
in the anchored form

    sa[slot]  = text position occupying SA slot ``slot``
    rank[pos] = slot of the first member of pos's group
    gs[slot]  = rank[sa[slot]], the group start of every slot

from CUDA kernels (``csrc/suffix_array_kernels.cu``), each with a plain
PyTorch version beside it:

- :func:`sa_init_ranked` (B1): the anchored init sort on 2 x (30 // bits)
  rank digits;
- :func:`sa_init_bytes` (B1b): the anchored init sort on 6 byte + 1
  digits;
- :func:`sa_refine_round` (B2): one doubling round over the tied slots;
- :func:`sa_init3_bytes`, :func:`sa_window_scan` and
  :func:`sa_rotating_pass` (B10): the 3-byte init and the windowed passes
  of the rotating doubler;
- :func:`sa_full_init_bytes` and :func:`sa_full_round` (B9): full-sort
  prefix doubling with dense ranks, the JAX ``_doubling_kernel`` and
  ``_int_doubling_kernel``.

The Writer's device build (:func:`build_suffix_array` with ``'torch'``, or
``'auto'`` on a CUDA card) runs :func:`suffix_array_torch`, and
:func:`suffix_array_int` builds over an integer alphabet.

Their building blocks are kernels of the same file, exposed for tests:
:func:`radix_sort_pairs` (stable LSD radix sort of uint64 keys with int32
values), :func:`scan_exclusive_sum` and :func:`scan_inclusive_max`; and
:func:`scatter` (B16) is the radix sort's store pass alone.  Every
wrapper takes its plain version only for CPU tensors; on a CUDA tensor it
launches its kernel or raises.  The kernel sorts and the plain sorts are
both stable and see positions in slot order, so on the card they agree bit
for bit.
"""

from __future__ import annotations

import threading
import typing

import numpy as np
import torch

from . import kernels

__all__ = ['build_suffix_array', 'derive_sa', 'derive_sa_full',
           'derive_sa_plain', 'segmented_rotating_sa', 'segmented_sa',
           'suffix_array_int', 'suffix_array_numpy', 'suffix_array_torch']


def _doubling_numpy(rank: np.ndarray) -> np.ndarray:
    """Prefix-doubling SA on the host over int64 symbols."""
    n = rank.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        if k < n:
            rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        r1 = rank[order]
        r2 = rank2[order]
        flags = np.empty(n, dtype=np.int64)
        flags[0] = 0
        flags[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank_sorted = np.cumsum(flags)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        if new_rank_sorted[-1] == n - 1 or k >= n:
            break
        k *= 2
    return order.astype(np.int32)


def suffix_array_numpy(data: np.ndarray) -> np.ndarray:
    """Prefix-doubling SA on the host; ground truth for the native kernel."""
    return _doubling_numpy(np.asarray(data, dtype=np.uint8).astype(np.int64))


def _pad_len(n: int) -> int:
    """Padded row length for an n-byte row: a power of two below 16 MiB,
    16 MiB granularity above (the device index's row geometry)."""
    step = 1 << 24
    if n >= step:
        return -(-n // step) * step
    p = 8
    while p < n:
        p *= 2
    return p


#: Chunks of at least this many bytes are built on the card by ``'auto'``
#: when CUDA is available (the JAX package's ``_JAX_MIN_N``).
DEVICE_MIN_N = 1 << 16

#: Serialises the device part of every build, so the Writer's concurrent
#: workers neither add up their memory peaks nor interleave their rounds.
_DEVICE_BUILD_LOCK = threading.Lock()


def build_suffix_array(data: np.ndarray, backend: str = 'auto') -> np.ndarray:
    """Suffix array of ``data`` (uint8) with the chosen backend:
    ``'native'`` (C++ SA-IS), ``'numpy'``, ``'torch'``
    (:func:`suffix_array_torch` on the CUDA card; raises without one), or
    ``'auto'``: the card for a
    chunk of at least ``DEVICE_MIN_N`` bytes when CUDA is available, as the
    JAX ``auto`` picks the device on a co-located accelerator, else native
    SA-IS (numpy where no C++ compiler could build it)."""
    data = np.asarray(data, dtype=np.uint8)
    if backend == 'numpy':
        return suffix_array_numpy(data)
    if backend == 'torch':
        return suffix_array_torch(data)
    from . import native

    if backend == 'native':
        return native.suffix_array_native(data)
    if backend != 'auto':
        raise ValueError(f'unknown suffix-array backend: {backend!r}')
    if data.size >= DEVICE_MIN_N and torch.cuda.is_available():
        return suffix_array_torch(data)
    if native.available():
        return native.suffix_array_native(data)
    return suffix_array_numpy(data)


def _build_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'the torch suffix-array build needs a CUDA device; it never '
            'builds on the host'
        )
    return dev


def suffix_array_torch(data: np.ndarray, *,
                       device: typing.Union[str, torch.device] = 'cuda',
                       algorithm: str = 'segmented') -> np.ndarray:
    """The SA of ``data`` (uint8) built on ``device`` and read back as host
    int32 [n], the counterpart of the JAX ``suffix_array_jax``.  The chunk
    is padded to ``N = _pad_len(n + 6)``, B1b's contract.  ``'segmented'``
    runs :func:`segmented_sa` (B1b, then B2 from k = 6) at every N, as the
    JAX function runs ``_segmented_kernel``; ``'full'`` runs B9
    (:func:`sa_full_doubling`).  On the CPU device the plain versions run.
    The device part holds a module lock."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    if algorithm not in ('segmented', 'full'):
        raise ValueError(f'unknown SA algorithm: {algorithm!r}')
    dev = _build_device(device)
    N = _pad_len(n + BYTE_INIT_WIDTH)
    padded = np.zeros(N, dtype=np.uint8)
    padded[:n] = data
    with _DEVICE_BUILD_LOCK:
        text = torch.from_numpy(padded).to(dev)
        if algorithm == 'segmented':
            sa = segmented_sa(text, n)[0]
        else:
            sa = sa_full_doubling(text, n)
        return sa[N - n:].cpu().numpy()


def suffix_array_int(data: np.ndarray, k: typing.Optional[int] = None,
                     backend: str = 'auto') -> np.ndarray:
    """SA over an integer alphabet ``[0, k)`` (``libsais_int`` parity), a
    proper prefix sorting before any extension; ``k`` defaults to
    ``max(data) + 1``.  ``'native'`` and ``'auto'`` run the C++ SA-IS
    (``'auto'`` falls back to numpy without it), ``'torch'`` B9's integer
    form on the CUDA card (:func:`suffix_array_int_torch`), anything else
    host prefix doubling."""
    data = np.ascontiguousarray(data, dtype=np.int32)
    if data.size and data.min() < 0:
        raise ValueError('alphabet values must be non-negative')
    if k is None:
        k = int(data.max()) + 1 if data.size else 1
    if data.size and int(data.max()) >= k:
        raise ValueError('alphabet value out of range')
    if k > 1 << 30:
        raise ValueError('alphabet too large (k must be <= 2**30)')
    if backend in ('native', 'auto'):
        from . import native

        if native.available():
            return native.suffix_array_int_native(data, k)
        if backend == 'native':
            raise RuntimeError('native backend unavailable')
    if backend == 'torch':
        return suffix_array_int_torch(data)
    return _doubling_numpy(data.astype(np.int64))


def suffix_array_int_torch(data: np.ndarray, *,
                           device: typing.Union[str, torch.device] = 'cuda'
                           ) -> np.ndarray:
    """The SA of int32 ``data`` (values in [0, 2^30)) by B9's integer form
    on ``device`` (:func:`sa_full_doubling_int`), as the JAX
    ``_suffix_array_int_jax``: ranks start as value + 1 in a row padded to
    ``_pad_len(n)`` with 0."""
    data = np.ascontiguousarray(data, dtype=np.int32)
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    dev = _build_device(device)
    N = _pad_len(n)
    padded = np.zeros(N, dtype=np.int32)
    padded[:n] = data + 1
    with _DEVICE_BUILD_LOCK:
        sa_full = sa_full_doubling_int(torch.from_numpy(padded).to(dev))
        return sa_full[N - n:].cpu().numpy()


# ---------------------------------------------------------------------------
# Device building blocks: kernel wrappers and their plain PyTorch versions
# ---------------------------------------------------------------------------

def radix_sort_pairs_plain(keys: torch.Tensor, vals: torch.Tensor,
                           key_bits: int):
    """Plain version: (keys, vals) stably sorted by key."""
    del key_bits  # torch.sort compares whole keys
    keys_s, order = torch.sort(keys, stable=True)
    return keys_s, vals[order]


def radix_sort_pairs(keys: torch.Tensor, vals: torch.Tensor, key_bits: int):
    """Sort int64 [n] keys (non-negative, below 2^key_bits) with their int32
    [n] values stably, in place; returns (keys, vals)."""
    if not 0 < key_bits <= 63:
        raise ValueError('radix_sort_pairs: key_bits must be in 1..63')
    if not kernels.route(keys, vals):
        ks, vs = radix_sort_pairs_plain(keys, vals, key_bits)
        keys.copy_(ks)
        vals.copy_(vs)
        return keys, vals
    kernels.check(keys, 'keys', torch.int64, 1)
    kernels.check(vals, 'vals', torch.int32, 1)
    n = keys.shape[0]
    if vals.shape[0] != n:
        raise ValueError('radix_sort_pairs: keys and vals differ in length')
    scratch = kernels.scratch('radix_sort', n, keys.device)
    with torch.cuda.device(keys.device):
        kernels.launch('radix_sort_pairs', keys.data_ptr(), vals.data_ptr(),
                       n, key_bits, scratch.data_ptr())
    return keys, vals


def scatter_plain(values: torch.Tensor, dests: torch.Tensor,
                  out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``out[dests] = values``, into a new tensor like
    ``values`` when ``out`` is not given."""
    if out is None:
        out = torch.empty_like(values)
    out[dests.long()] = values
    return out


def scatter(values: torch.Tensor, dests: torch.Tensor,
            out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """B16, the store pass of an LSD radix sort: ``out[dests[i]] =
    values[i]`` for int32 [n] ``values`` and ``dests``, into int32 ``out``
    (a new [n] tensor when not given).  Replaces ``pallas_scatter``
    (``benchmarks/pallas_sort_bench.py``).  The caller's contract, as in
    that benchmark, which scatters by a permutation: the dests are distinct
    and inside ``out``; the card does not check it, and a slot no dest
    names keeps what ``out`` held.  Any n: the JAX kernel's multiple of
    8192 was the tile of its VMEM blocks, not a property of the function."""
    if out is None:
        out = torch.empty_like(values)
    if not kernels.route(values, dests, out):
        return scatter_plain(values, dests, out)
    for t, name in ((values, 'values'), (dests, 'dests'), (out, 'out')):
        kernels.check(t, name, torch.int32, 1)
    n = values.shape[0]
    if dests.shape[0] != n:
        raise ValueError('scatter: values and dests differ in length')
    with torch.cuda.device(values.device):
        kernels.launch('scatter', values.data_ptr(), dests.data_ptr(), n,
                       out.data_ptr())
    return out


def scan_exclusive_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: int32 [n + 1], out[i] = sum of x[:i], out[n] the
    total."""
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int32, device=x.device)
    out[1:] = torch.cumsum(x, 0)
    return out


def scan_exclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive sum scan of int32 [n] with the total appended: int32
    [n + 1] (see :func:`scan_exclusive_sum_plain`)."""
    if not kernels.route(x):
        return scan_exclusive_sum_plain(x)
    kernels.check(x, 'x', torch.int32, 1)
    n = x.shape[0]
    out = torch.empty(n + 1, dtype=torch.int32, device=x.device)
    scratch = kernels.scratch('scan', n, x.device)
    with torch.cuda.device(x.device):
        kernels.launch('scan_exclusive_sum', x.data_ptr(), out.data_ptr(), n,
                       scratch.data_ptr())
    return out


def scan_inclusive_max_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: int32 [n], out[i] = max of x[:i + 1]."""
    return torch.cummax(x, 0).values.to(torch.int32)


def scan_inclusive_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive max scan of int32 [n] (``lax.cummax``)."""
    if not kernels.route(x):
        return scan_inclusive_max_plain(x)
    kernels.check(x, 'x', torch.int32, 1)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    scratch = kernels.scratch('scan', n, x.device)
    with torch.cuda.device(x.device):
        kernels.launch('scan_inclusive_max', x.data_ptr(), out.data_ptr(), n,
                       scratch.data_ptr())
    return out


# ---------------------------------------------------------------------------
# B1 and B2: the device SA build
# ---------------------------------------------------------------------------

#: Device bytes one row's SA build holds per padded slot at its peak, on
#: top of the row's text and SA: the working sa / rank / gs (12), and the
#: init's sort keys, values and their double buffers with the group-start
#: array (28), or a round's tie flags and offsets (8) with its buffers
#: over at most every slot (36); with headroom over the largest peak
#: measured, the digit kind's all-tied first round: 14.06 GiB above the
#: index for a 256 Mi-slot row (56.2 bytes a slot, its SA output included;
#: ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W).  Past
#: SEGMENTED_MAX_N the same script measured less: B10 20.13 GiB at 512 Mi
#: (40.3 bytes a slot), B9 after a poisoned B10 18.38 GiB at 416 Mi (45.3).
SA_BUILD_BYTES_PER_SLOT = 60


def _key_width(N: int) -> int:
    """Bits W with 2^W > N: group starts and r2 + 1 both fit in W bits."""
    return N.bit_length()


#: Text positions the byte init (B1b) keys on, and so its pad margin.
BYTE_INIT_WIDTH = 6


def _check_pad_contract(N: int, n: int,
                        bits: typing.Optional[int]) -> None:
    """B1 needs ``n + 30 // bits <= N``, B1b (``bits`` None) ``n + 6 <=
    N``."""
    if bits is None:
        margin = BYTE_INIT_WIDTH
    elif bits in (5, 6):
        margin = 30 // bits
    else:
        raise ValueError(f'ranked digits are 5 or 6 bits, got {bits}')
    # The derive path's PAD_MARGIN guarantees it: positions within the
    # margin of the row's end lie past n, so the pad positions are exactly
    # the all-zero key group and sort first, as in the JAX inits.
    if not (0 <= n and n + margin <= N):
        raise ValueError(
            f'pad contract: need n + {margin} <= N, got n={n}, N={N}'
        )


def _shifted(e: torch.Tensor, d: int) -> torch.Tensor:
    """e[p + d], 0 past the end of the row."""
    out = torch.zeros_like(e)
    out[: max(e.shape[0] - d, 0)] = e[d:]
    return out


def _init_from_key(key: torch.Tensor, n: int):
    """The anchored init from one int64 key per position: the stable sort,
    the pad slots in their known order with singleton groups forced, the
    group-start max-scan and the rank scatter."""
    N = key.shape[0]
    dev = key.device
    iota = torch.arange(N, device=dev)
    keys_s, idx = torch.sort(key, stable=True)
    npad = N - n
    sa = torch.where(iota < npad, N - 1 - iota, idx)
    changed = iota <= npad
    changed[1:] |= keys_s[1:] != keys_s[:-1]
    gs = torch.cummax(torch.where(changed, iota, 0), 0).values
    rk = torch.empty(N, dtype=torch.int64, device=dev)
    rk[sa] = gs
    return sa.to(torch.int32), rk.to(torch.int32), gs.to(torch.int32)


def _ranked_key(text: torch.Tensor, n: int, rank: torch.Tensor,
                bits: int) -> torch.Tensor:
    """int64 [N]: the first 2D rank digits of every suffix (D = 30 //
    bits) packed big-endian, 0 for a digit at or past n."""
    iota = torch.arange(text.shape[0], device=text.device)
    e = torch.where(iota < n, rank.long()[text.long()], 0)
    key = torch.zeros_like(e)
    for d in range(2 * (30 // bits)):
        key = (key << bits) | _shifted(e, d)
    return key


def sa_init_ranked_plain(text: torch.Tensor, n: int, rank: torch.Tensor,
                         bits: int):
    """Plain version of B1: (sa, rank, gs) int32 [N] of the anchored init
    sort over :func:`_ranked_key`."""
    return _init_from_key(_ranked_key(text, n, rank, bits), n)


def sa_init_ranked(text: torch.Tensor, n: int, rank: torch.Tensor,
                   bits: int):
    """B1, the anchored init sort of a padded uint8 [N] text row of true
    length ``n`` with the byte -> rank map ``rank`` int32 [256]: (sa, rank,
    gs) int32 [N] (see :func:`sa_init_ranked_plain`).  Replaces
    ``_init_round_anchored_ranked``; needs ``n + 30 // bits <= N``."""
    N = text.shape[0]
    _check_pad_contract(N, n, bits)
    if not kernels.route(text, rank):
        return sa_init_ranked_plain(text, n, rank, bits)
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(rank, 'rank', torch.int32, 1)
    if rank.shape[0] != 256:
        raise ValueError('sa_init_ranked: rank must have 256 entries')
    dev = text.device
    sa, rk, gs = (torch.empty(N, dtype=torch.int32, device=dev)
                  for _ in range(3))
    scratch = kernels.scratch('sa_init', N, dev)
    with torch.cuda.device(dev):
        kernels.launch('sa_init_ranked', text.data_ptr(), N, int(n),
                       rank.data_ptr(), bits, sa.data_ptr(), rk.data_ptr(),
                       gs.data_ptr(), scratch.data_ptr())
    return sa, rk, gs


def _byte_key(text: torch.Tensor, n: int,
              width: int = BYTE_INIT_WIDTH) -> torch.Tensor:
    """int64 [N]: the first ``width`` (6 or 3) digits of every suffix,
    digit byte + 1 and 0 at or past n, keyed as ``limb0 << 25 | limb1``
    (three base-257 digits each, 257^3 < 2^25), or ``limb0`` alone for 3."""
    iota = torch.arange(text.shape[0], device=text.device)
    e = torch.where(iota < n, text.long() + 1, 0)
    limbs = [torch.zeros_like(e), torch.zeros_like(e)]
    for d in range(width):
        limbs[d // 3] = limbs[d // 3] * 257 + _shifted(e, d)
    return (limbs[0] << 25) | limbs[1] if width > 3 else limbs[0]


def sa_init_bytes_plain(text: torch.Tensor, n: int):
    """Plain version of B1b: (sa, rank, gs) int32 [N] of the anchored init
    sort over the first 6 digits of every suffix (:func:`_byte_key`)."""
    return _init_from_key(_byte_key(text, n), n)


def sa_init_bytes(text: torch.Tensor, n: int):
    """B1b, the 6-byte anchored init sort of a padded uint8 [N] text row of
    true length ``n``: (sa, rank, gs) int32 [N] (see
    :func:`sa_init_bytes_plain`).  Replaces ``_init_round_anchored``; needs
    ``n + 6 <= N``."""
    _check_pad_contract(text.shape[0], n, None)
    return _init_bytes(text, n, 'sa_init_bytes', BYTE_INIT_WIDTH)


def _init_bytes(text: torch.Tensor, n: int, name: str, width: int):
    """The anchored init on ``width`` byte digits by the kernel ``name``
    (B1b at 6, B10's at 3), on any ``0 <= n <= N``: the key kernel masks
    every read at n, so the pad positions are exactly the all-zero key
    group without a margin."""
    N = text.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f'{name}: need 0 <= n <= N, got n={n}, N={N}')
    if not kernels.route(text):
        return _init_from_key(_byte_key(text, n, width), n)
    kernels.check(text, 'text', torch.uint8, 1)
    dev = text.device
    sa, rk, gs = (torch.empty(N, dtype=torch.int32, device=dev)
                  for _ in range(3))
    scratch = kernels.scratch('sa_init', N, dev)
    with torch.cuda.device(dev):
        kernels.launch(name, text.data_ptr(), N, int(n), sa.data_ptr(),
                       rk.data_ptr(), gs.data_ptr(), scratch.data_ptr())
    return sa, rk, gs


def _tied_plain(gs: torch.Tensor) -> torch.Tensor:
    """tied[slot]: slot's group has two or more members."""
    eq_next = torch.zeros(gs.shape[0], dtype=torch.bool, device=gs.device)
    eq_next[:-1] = gs[:-1] == gs[1:]
    tied = eq_next.clone()
    tied[1:] |= eq_next[:-1]
    return tied


def _round_keys(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                k: int, marked: typing.Optional[torch.Tensor] = None):
    """A B2 round's (tied slots, or the ``marked`` ones, their positions,
    their int64 keys ``gs << W | (rank[pos + k] + 1)``, 0 past the row) in
    slot order."""
    N = sa.shape[0]
    if marked is None:
        marked = _tied_plain(gs)
    slots = torch.nonzero(marked).flatten()
    pos = sa[slots].long()
    q = pos + k
    r2 = torch.where(q < N, rank[q.clamp(max=N - 1)].long(), -1)
    return slots, pos, (gs[slots].long() << _key_width(N)) | (r2 + 1)


def sa_refine_round_plain(sa: torch.Tensor, rank: torch.Tensor,
                          gs: torch.Tensor, k: int) -> int:
    """Plain version of B2: refine every tied group by the rank ``k``
    positions on, in place; returns the tie count m."""
    return _refine_plain(sa, rank, gs, k)


def _refine_plain(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                  k: int, marked: typing.Optional[torch.Tensor] = None
                  ) -> int:
    """B2's refine body on the tied slots, or on the ``marked`` ones (whole
    runs of their groups' first slots), in place; returns their count."""
    slots, pos, key = _round_keys(sa, rank, gs, k, marked)
    m = slots.shape[0]
    if m == 0:
        return 0
    key_s, order = torch.sort(key, stable=True)
    pos_s = pos[order]
    change = torch.ones(m, dtype=torch.bool, device=sa.device)
    change[1:] = key_s[1:] != key_s[:-1]
    first_eq = torch.cummax(torch.where(change, slots, 0), 0).values
    first_eq = first_eq.to(torch.int32)
    sa[slots] = pos_s.to(torch.int32)
    rank[pos_s] = first_eq
    gs[slots] = first_eq
    return m


def sa_refine_round(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                    k: int) -> int:
    """B2, one tie-only doubling round on int32 [N] (sa, rank, gs), in
    place; returns the tie count m, read back once (see
    :func:`sa_refine_round_plain`).  Replaces the body of
    ``_segmented_loop`` with ``_tied_flags`` and ``_relabel_and_scatter``;
    the round's buffers are sized from m, so no full-size fallback
    branch exists."""
    if not kernels.route(sa, rank, gs):
        return sa_refine_round_plain(sa, rank, gs, k)
    for t, name in ((sa, 'sa'), (rank, 'rank'), (gs, 'gs')):
        kernels.check(t, name, torch.int32, 1)
    N = sa.shape[0]
    if rank.shape[0] != N or gs.shape[0] != N:
        raise ValueError('sa_refine_round: sa, rank and gs differ in length')
    dev = sa.device
    flags = torch.empty(N, dtype=torch.int32, device=dev)
    dest = torch.empty(N + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        scratch = kernels.scratch('sa_tie', N, dev)
        kernels.launch('sa_tie_scan', gs.data_ptr(), N, flags.data_ptr(),
                       dest.data_ptr(), scratch.data_ptr())
        del scratch
        m = int(dest[N])
        if m == 0:
            return 0
        scratch = kernels.scratch('sa_refine', m, dev)
        kernels.launch('sa_refine_round', sa.data_ptr(), rank.data_ptr(),
                       gs.data_ptr(), N, int(k), m, flags.data_ptr(),
                       dest.data_ptr(), scratch.data_ptr())
    return m


def sa_roll_front_plain(sa_full: torch.Tensor, n: int,
                        out: typing.Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version: ``sa_full`` rolled by n - N, into ``out`` if given."""
    rolled = torch.roll(sa_full, n - sa_full.shape[0])
    return rolled if out is None else out.copy_(rolled)


def sa_roll_front(sa_full: torch.Tensor, n: int,
                  out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """The anchored SA of a row rolled to the front, as the JAX derive
    returns it: slots [0, n) hold the SA of the text, the tail N - 1, ...,
    n.  Writes into ``out`` (a row of the stacked index) when given."""
    N = sa_full.shape[0]
    if out is None:
        out = torch.empty_like(sa_full)
    if not kernels.route(sa_full, out):
        return sa_roll_front_plain(sa_full, n, out)
    kernels.check(sa_full, 'sa_full', torch.int32, 1)
    kernels.check(out, 'out', torch.int32, 1)
    if out.shape[0] != N:
        raise ValueError('sa_roll_front: bad output shape')
    with torch.cuda.device(sa_full.device):
        kernels.launch('sa_roll_front', sa_full.data_ptr(), N, int(n),
                       out.data_ptr())
    return out


def _segmented(init_ranked, init_bytes, refine, text, n, rank, bits):
    N = text.shape[0]
    _check_pad_contract(N, n, bits)
    if bits is None:
        sa, rk, gs = init_bytes(text, n)
        k = BYTE_INIT_WIDTH
    else:
        if rank is None:
            raise ValueError('derive_sa: ranked digits need the rank map')
        sa, rk, gs = init_ranked(text, n, rank, bits)
        k = 2 * (30 // bits)
    ties: typing.List[int] = []
    while k < N:
        m = refine(sa, rk, gs, k)
        if m == 0:
            break
        ties.append(m)
        k *= 2
    return sa, ties


def segmented_sa(text: torch.Tensor, n: int,
                 rank: typing.Optional[torch.Tensor] = None,
                 bits: typing.Optional[int] = None):
    """The anchored SA of a padded uint8 [N] text row of true length ``n``
    by tie-only doubling, pad slots first as ``_segmented_kernel`` returns
    it: (sa_full int32 [N], the tie count m of every round run).  With
    ``bits`` None, B1b and then B2 from k = 6; with a ranked alphabet's
    ``rank`` and ``bits``, B1 and then B2 from k = 2 * (30 // bits)
    (``_segmented_kernel_ranked``).  The rounds double k while k < N and
    ties remain; the host reads each round's m once."""
    return _segmented(sa_init_ranked, sa_init_bytes, sa_refine_round, text,
                      n, rank, bits)


def segmented_sa_plain(text: torch.Tensor, n: int,
                       rank: typing.Optional[torch.Tensor] = None,
                       bits: typing.Optional[int] = None):
    """:func:`segmented_sa` through the plain versions on any device."""
    return _segmented(sa_init_ranked_plain, sa_init_bytes_plain,
                      sa_refine_round_plain, text, n, rank, bits)


# ---------------------------------------------------------------------------
# B10: the rotating windowed doubler of rows over SEGMENTED_MAX_N
# ---------------------------------------------------------------------------
#
# The JAX package sorts at most S = N / 8 elements at once on such rows, so
# that a 512 MiB row's program fits 16 GB of HBM: each k-round sweeps the
# slot space in windows, and a window refines every tied group whose start
# slot lies in [off, off + W), W = S / 2, whole groups only.  A group of
# more than S / 2 members cannot be refined in a window, so its presence
# poisons the row, and the caller re-derives it by full-sort doubling (B9,
# :func:`derive_sa_full`).  Natural text never trips it; one-symbol runs do.
# The port keeps the schedule, the window and the poison rule exactly, so
# its SA and its ``poisoned`` are the JAX function's.

#: Padded rows longer than this derive through B10, shorter ones through
#: B1/B1b and B2, as the JAX ``derive_sa`` splits at ``3 << 27``.
SEGMENTED_MAX_N = 3 << 27

#: B10's sort bound is S = N // _SEG_DIV slots (the JAX ``_SEG_DIV``).
_SEG_DIV = 8

#: Fields of B10's device control block, int32 [5] (``csrc``'s kCtl*).
_CTL_OFF, _CTL_MW, _CTL_POISONED, _CTL_ANY_TIED, _CTL_NEXT = range(5)


def _rotating_sizes(N: int) -> typing.Tuple[int, int]:
    """(S // 2, W): the member-offset bound and the window of group starts
    of a row of N slots, with the JAX ``S = max(N // 8, 8)`` and ``W =
    max(S // 2, 4)``."""
    S = max(N // _SEG_DIV, 8)
    return S // 2, max(S // 2, 4)


def sa_init3_bytes_plain(text: torch.Tensor, n: int):
    """Plain version of B10's init: (sa, rank, gs) int32 [N] of the
    anchored init sort over the first 3 digits of every suffix."""
    return _init_from_key(_byte_key(text, n, 3), n)


def sa_init3_bytes(text: torch.Tensor, n: int):
    """B10's 3-byte anchored init of a uint8 [N] text row of true length
    ``0 <= n <= N`` (no margin needed): (sa, rank, gs) int32 [N], k covered
    = 3.  One (key, position) radix sort on 25 key bits, then B1b's anchored
    tail.  Replaces ``_init_round_anchored3``."""
    return _init_bytes(text, n, 'sa_init3_bytes', 3)


def _new_ctl(N: int, off: int, device) -> torch.Tensor:
    return torch.tensor([off, 0, 0, 0, N], dtype=torch.int32, device=device)


def sa_window_scan_plain(gs: torch.Tensor, ctl: torch.Tensor,
                         flags: torch.Tensor, dest: torch.Tensor, half: int,
                         W: int) -> None:
    """Plain version of B10's window scan: for the window at ``ctl[0]``,
    ``flags`` int32 [N] marks every tied slot whose group start g lies in
    [off, off + W) with a member offset ``slot - g`` below ``half``,
    ``dest`` int32 [N + 1] is their exclusive scan with the count m_w last,
    and ``ctl`` gets m_w, poisoned (a tied slot at a member offset of
    ``half`` or more) and whether any slot is tied."""
    N = gs.shape[0]
    off = int(ctl[_CTL_OFF])
    tied = _tied_plain(gs)
    member = torch.arange(N, device=gs.device) - gs.long()
    sel = tied & (member < half) & (gs >= off) & (gs.long() < off + W)
    flags.copy_(sel.to(torch.int32))
    dest.copy_(scan_exclusive_sum_plain(flags))
    ctl[_CTL_MW] = dest[N]
    ctl[_CTL_POISONED] = int(bool((tied & (member >= half)).any()))
    ctl[_CTL_ANY_TIED] = int(bool(tied.any()))


def sa_window_scan(gs: torch.Tensor, ctl: torch.Tensor, flags: torch.Tensor,
                   dest: torch.Tensor, half: int, W: int) -> None:
    """B10's window scan on the card, in place on ``flags``, ``dest`` and
    the control block ``ctl`` int32 [5] (see
    :func:`sa_window_scan_plain`); the window's offset is read from
    ``ctl[0]`` on the device.  The selection of ``_rotating_pass``."""
    if not kernels.route(gs, ctl, flags, dest):
        return sa_window_scan_plain(gs, ctl, flags, dest, half, W)
    N = gs.shape[0]
    for t, name, size in ((gs, 'gs', N), (ctl, 'ctl', 5), (flags, 'flags', N),
                          (dest, 'dest', N + 1)):
        kernels.check(t, name, torch.int32, 1)
        if t.shape[0] != size:
            raise ValueError(f'sa_window_scan: {name} needs {size} entries')
    dev = gs.device
    with torch.cuda.device(dev):
        scratch = kernels.scratch('sa_tie', N, dev)
        kernels.launch('sa_window_scan', gs.data_ptr(), N, int(half), int(W),
                       ctl.data_ptr(), flags.data_ptr(), dest.data_ptr(),
                       scratch.data_ptr())


def _window_refine_plain(sa, rank, gs, k, m, W, flags, dest, ctl) -> None:
    """Plain version of :func:`_window_refine`."""
    del m, dest  # the marks alone say which slots
    N = gs.shape[0]
    _refine_plain(sa, rank, gs, k, flags.bool())
    off = int(ctl[_CTL_OFF])
    start = torch.ones(N, dtype=torch.bool, device=gs.device)
    start[1:] = gs[1:] != gs[:-1]
    starts = torch.nonzero(start & _tied_plain(gs)).flatten()
    later = starts[starts >= off + W]
    nxt = int(later[0]) if later.numel() else N
    ctl[_CTL_NEXT] = nxt
    ctl[_CTL_OFF] = nxt if nxt < N else 0


def _window_refine(sa, rank, gs, k, m, W, flags, dest, ctl) -> None:
    """The rest of a B10 pass on the card (``pss_sa_rotating_pass``): B2's
    refine body on the m marked slots of the last window scan by the rank
    ``k`` positions on, in place, then the jump: ``ctl[4]`` = the least
    slot at or past ``off + W`` that starts a tied group (N if none, or if
    off + W >= N) and ``ctl[0]`` = it, or 0 at N."""
    if not kernels.route(sa, rank, gs, flags, dest, ctl):
        return _window_refine_plain(sa, rank, gs, k, m, W, flags, dest, ctl)
    N = gs.shape[0]
    for t, name in ((sa, 'sa'), (rank, 'rank'), (gs, 'gs')):
        kernels.check(t, name, torch.int32, 1)
        if t.shape[0] != N:
            raise ValueError('sa_rotating_pass: sa, rank and gs differ in '
                             'length')
    dev = gs.device
    with torch.cuda.device(dev):
        scratch = kernels.scratch('sa_refine', m, dev)
        kernels.launch('sa_rotating_pass', sa.data_ptr(), rank.data_ptr(),
                       gs.data_ptr(), N, int(k), int(m), int(W),
                       flags.data_ptr(), dest.data_ptr(), ctl.data_ptr(),
                       scratch.data_ptr())


def _pass(scan, refine, sa, rank, gs, k, off, poisoned):
    N = gs.shape[0]
    half, W = _rotating_sizes(N)
    ctl = _new_ctl(N, off, gs.device)
    flags = torch.empty(N, dtype=torch.int32, device=gs.device)
    dest = torch.empty(N + 1, dtype=torch.int32, device=gs.device)
    scan(gs, ctl, flags, dest, half, W)
    _, m, pois, _, _ = ctl.tolist()
    refine(sa, rank, gs, k, m, W, flags, dest, ctl)
    off = int(ctl[_CTL_OFF])
    # The jump lands at or past W >= 4, so 0 means the round is swept.
    return (2 * k if off == 0 else k), off, poisoned or bool(pois), m


def sa_rotating_pass(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                     k: int, off: int, poisoned: bool = False):
    """One B10 pass, the JAX ``_rotating_pass``, on int32 [N] (sa, rank,
    gs) in place: the window scan at ``off``, then the refine and the jump
    (:func:`_window_refine`).  Returns the new (k, off, poisoned) and the
    window's m_w.  Reads the control block twice (the loop of
    :func:`segmented_rotating_sa` once a pass)."""
    return _pass(sa_window_scan, _window_refine, sa, rank, gs, k, off,
                 poisoned)


def sa_rotating_pass_plain(sa: torch.Tensor, rank: torch.Tensor,
                           gs: torch.Tensor, k: int, off: int,
                           poisoned: bool = False):
    """:func:`sa_rotating_pass` through the plain versions."""
    return _pass(sa_window_scan_plain, _window_refine_plain, sa, rank, gs, k,
                 off, poisoned)


def _rotating(init6, init3, scan, refine, text, n):
    N = text.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f'segmented_rotating_sa: need 0 <= n <= N, got '
                         f'n={n}, N={N}')
    half, W = _rotating_sizes(N)
    if N <= 1 << 28:
        sa, rank, gs = init6(text, n)
        k = BYTE_INIT_WIDTH
    else:
        sa, rank, gs = init3(text, n)
        k = 3
    dev = text.device
    ctl = _new_ctl(N, 0, dev)
    flags = torch.empty(N, dtype=torch.int32, device=dev)
    dest = torch.empty(N + 1, dtype=torch.int32, device=dev)
    scan(gs, ctl, flags, dest, half, W)
    rounds: typing.List[typing.List[int]] = [[]]
    poisoned = False
    while True:
        off, m, pois, any_tied, _ = ctl.tolist()  # the one read of a pass
        if rounds[-1] and off == 0:  # the last pass swept its round
            k *= 2
            rounds.append([])
        if not ((k < N or off > 0) and any_tied):
            break
        if pois:  # only ever turns on, and every caller discards the SA
            poisoned = True
            break
        refine(sa, rank, gs, k, m, W, flags, dest, ctl)
        rounds[-1].append(m)
        scan(gs, ctl, flags, dest, half, W)
    return sa, poisoned, [r for r in rounds if r]


def segmented_rotating_sa(text: torch.Tensor, n: int):
    """B10, the JAX ``segmented_rotating_sa``: the anchored SA of a uint8
    [N] text row of true length ``0 <= n <= N``, pad slots first, by
    windowed tie-only doubling that never sorts more than N / 8 elements.
    The init is B1b's 6 bytes (k = 6) for N <= 2^28, else
    :func:`sa_init3_bytes` (k = 3); then passes while k < N or a round is
    mid-sweep, and some slot is tied, each a window scan and
    :func:`_window_refine`, with one read of the control block a pass.
    Returns (sa_full int32 [N], poisoned, the m_w of every pass, by
    round).  ``poisoned`` True means the SA is not to be trusted: the row
    holds a group too big for a window, and the loop stops at the first
    window that finds one."""
    return _rotating(_init6_any, sa_init3_bytes, sa_window_scan,
                     _window_refine, text, n)


def _init6_any(text: torch.Tensor, n: int):
    """B1b on any ``0 <= n <= N``, the init of B10's rows up to 2^28 (the
    JAX tests derive unpadded rows there)."""
    return _init_bytes(text, n, 'sa_init_bytes', BYTE_INIT_WIDTH)


def segmented_rotating_sa_plain(text: torch.Tensor, n: int):
    """:func:`segmented_rotating_sa` through the plain versions."""
    return _rotating(sa_init_bytes_plain, sa_init3_bytes_plain,
                     sa_window_scan_plain, _window_refine_plain, text, n)


def _derive(segmented, rotating, roll, text, n, rank, bits, out):
    if text.shape[0] > SEGMENTED_MAX_N:
        sa_full, poisoned, ties = rotating(text, n)
    else:
        (sa_full, ties), poisoned = segmented(text, n, rank, bits), False
    return roll(sa_full, n, out), ties, poisoned


def derive_sa(text: torch.Tensor, n: int,
              rank: typing.Optional[torch.Tensor] = None,
              bits: typing.Optional[int] = None,
              out: typing.Optional[torch.Tensor] = None):
    """The SA of a padded uint8 [N] text row of true length ``n``, built on
    the row's device, as the JAX ``derive_sa``: (sa int32 [N] rolled to the
    front, ties, poisoned).  Rows of up to ``SEGMENTED_MAX_N`` slots take
    :func:`segmented_sa` (``rank`` and ``bits`` pick B1 over B1b), with
    ``ties`` the m of every round and ``poisoned`` False; longer rows take
    :func:`segmented_rotating_sa`, which ignores ``rank`` and ``bits``, with
    ``ties`` the m_w of every pass by round, and ``poisoned`` True where the
    caller must re-derive the row (:func:`derive_sa_full`).  ``out`` (a row
    of the stacked index) receives the SA when given."""
    return _derive(segmented_sa, segmented_rotating_sa, sa_roll_front, text,
                   n, rank, bits, out)


def derive_sa_plain(text: torch.Tensor, n: int,
                    rank: typing.Optional[torch.Tensor] = None,
                    bits: typing.Optional[int] = None,
                    out: typing.Optional[torch.Tensor] = None):
    """:func:`derive_sa` through the plain versions on any device."""
    return _derive(segmented_sa_plain, segmented_rotating_sa_plain,
                   sa_roll_front_plain, text, n, rank, bits, out)


# ---------------------------------------------------------------------------
# B9: full-sort prefix doubling
# ---------------------------------------------------------------------------

def _dense_relabel(keys_s: torch.Tensor, idx: torch.Tensor):
    """(sa, rank, count) from stably sorted keys and their positions: dense
    ranks in sorted order, 0 for the smallest key."""
    change = torch.zeros(keys_s.shape[0], dtype=torch.int64,
                         device=keys_s.device)
    change[1:] = (keys_s[1:] != keys_s[:-1]).long()
    labels = torch.cumsum(change, 0)
    rank = torch.empty_like(labels)
    rank[idx] = labels
    return idx.to(torch.int32), rank.to(torch.int32), int(labels[-1]) + 1


def sa_full_init_bytes_plain(text: torch.Tensor, n: int):
    """Plain version of B9's init: (sa int32 [N], rank int32 [N], count):
    every position stably sorted by B1b's 6-digit key (:func:`_byte_key`),
    with dense ranks and their number."""
    keys_s, idx = torch.sort(_byte_key(text, n), stable=True)
    return _dense_relabel(keys_s, idx)


def sa_full_init_bytes(text: torch.Tensor, n: int):
    """B9's init on a uint8 [N] text row of true length ``n`` (see
    :func:`sa_full_init_bytes_plain`): B1b's key kernel, the radix sort and
    a dense relabel; the count is read back once.  Replaces
    ``_init_round``."""
    N = text.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f'sa_full_init_bytes: need 0 <= n <= N, got {n}')
    if not kernels.route(text):
        return sa_full_init_bytes_plain(text, n)
    kernels.check(text, 'text', torch.uint8, 1)
    dev = text.device
    sa, rk, count = (torch.empty(m, dtype=torch.int32, device=dev)
                     for m in (N, N, 1))
    with torch.cuda.device(dev):
        scratch = kernels.scratch('sa_full', N, dev)
        kernels.launch('sa_full_init_bytes', text.data_ptr(), N, int(n),
                       sa.data_ptr(), rk.data_ptr(), count.data_ptr(),
                       scratch.data_ptr())
    return sa, rk, int(count)


def _check_width(N: int, W: int) -> None:
    if not 0 < W <= 31 or (1 << W) <= N:
        raise ValueError(f'full round: need 2^W > N and W <= 31, got W={W}')


def sa_full_round_plain(sa: torch.Tensor, rank: torch.Tensor, k: int,
                        W: int) -> int:
    """Plain version of a B9 round: every position stably sorted by
    ``rank[i] << W | (rank[i + k] + 1)``, 0 past the row, then dense ranks,
    in place; returns their number.  Every rank must be below 2^W - 1."""
    _check_width(rank.shape[0], W)
    r = rank.long()
    keys_s, idx = torch.sort((r << W) | _shifted(r + 1, k), stable=True)
    new_sa, new_rank, count = _dense_relabel(keys_s, idx)
    sa.copy_(new_sa)
    rank.copy_(new_rank)
    return count


def sa_full_round(sa: torch.Tensor, rank: torch.Tensor, k: int,
                  W: int) -> int:
    """One B9 round on int32 [N] (sa, rank) in place (see
    :func:`sa_full_round_plain`): a key kernel, the radix sort on 2W bits
    and a dense relabel; the count is read back once.  Replaces
    ``_doubling_round``."""
    N = rank.shape[0]
    _check_width(N, W)
    if not kernels.route(sa, rank):
        return sa_full_round_plain(sa, rank, k, W)
    kernels.check(sa, 'sa', torch.int32, 1)
    kernels.check(rank, 'rank', torch.int32, 1)
    if sa.shape[0] != N:
        raise ValueError('sa_full_round: sa and rank differ in length')
    dev = rank.device
    count = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        scratch = kernels.scratch('sa_full', N, dev)
        kernels.launch('sa_full_round', sa.data_ptr(), rank.data_ptr(), N,
                       int(k), W, count.data_ptr(), scratch.data_ptr())
    return int(count)


def _full_rounds(round_fn, sa, rank, count, k):
    """Double k while k < N and some ranks tie, as ``_doubling_kernel``'s
    loop; returns the last round's sa."""
    N = rank.shape[0]
    W = _key_width(N)
    while k < N and count < N:
        count = round_fn(sa, rank, k, W)
        k *= 2
    return sa


def sa_full_doubling(text: torch.Tensor, n: int) -> torch.Tensor:
    """B9, the SA of a padded uint8 [N] text row of true length ``n`` by
    full-sort doubling, as the JAX ``_doubling_kernel`` returns it: int32
    [N] with the pad positions first and the text's SA in the last n
    slots.  The 6-byte init, then rounds from k = 6."""
    sa, rank, count = sa_full_init_bytes(text, n)
    return _full_rounds(sa_full_round, sa, rank, count, BYTE_INIT_WIDTH)


def sa_full_doubling_plain(text: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`sa_full_doubling` through the plain versions on any device."""
    sa, rank, count = sa_full_init_bytes_plain(text, n)
    return _full_rounds(sa_full_round_plain, sa, rank, count,
                        BYTE_INIT_WIDTH)


def derive_sa_full(text: torch.Tensor, n: int,
                   out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX ``derive_sa_full_jit``: B9 (:func:`sa_full_doubling`) rolled
    to the front, into ``out`` when given.  It re-derives a row that
    :func:`segmented_rotating_sa` flags as poisoned."""
    return sa_roll_front(sa_full_doubling(text, n), n, out)


def _int_doubling(round_fn, ranks: torch.Tensor) -> torch.Tensor:
    rank = ranks.to(torch.int32).clone()
    sa = torch.empty_like(rank)
    # The first round keys the raw ranks (up to 2^30, so W = 31 at most);
    # later rounds key dense ranks below N.
    W0 = max(_key_width(rank.shape[0]), (int(rank.max()) + 1).bit_length())
    count = round_fn(sa, rank, 1, W0)
    return _full_rounds(round_fn, sa, rank, count, 2)


def sa_full_doubling_int(ranks: torch.Tensor) -> torch.Tensor:
    """B9's integer form, the JAX ``_int_doubling_kernel``: the SA of int32
    [N] order-preserving ranks (value + 1, pad 0, at most 2^30), pad
    positions first; the first round at k = 1, then doubling from k = 2."""
    return _int_doubling(sa_full_round, ranks)


def sa_full_doubling_int_plain(ranks: torch.Tensor) -> torch.Tensor:
    """:func:`sa_full_doubling_int` through the plain round."""
    return _int_doubling(sa_full_round_plain, ranks)
