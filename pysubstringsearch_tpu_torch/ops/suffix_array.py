"""Suffix-array construction, on the host and on the device.

Host: two backends, one contract (``uint8[n] -> int32[n]``), with the
ordering of the on-disk container: plain bytewise order where a proper
prefix sorts before any extension.

- ``native``: the C++ SA-IS kernel in ``native/sais.cpp`` (:mod:`.native`);
- ``numpy``: host prefix doubling, the ground truth for tests.

The SA of a string is unique, so every backend gives identical bytes.

Device (derive mode): :func:`derive_sa` builds a padded text row's SA by
tie-only prefix doubling, as the JAX package's ``_segmented_kernel_ranked``
(ranked alphabets) and ``_segmented_kernel`` (any other) do, in the
anchored form

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
- :func:`sa_full_init_bytes` and :func:`sa_full_round` (B9): full-sort
  prefix doubling with dense ranks, the JAX ``_doubling_kernel`` and
  ``_int_doubling_kernel``.

The Writer's device build (:func:`build_suffix_array` with ``'torch'``, or
``'auto'`` on a CUDA card) runs :func:`suffix_array_torch`, and
:func:`suffix_array_int` builds over an integer alphabet.

Their building blocks are kernels of the same file, exposed for tests:
:func:`radix_sort_pairs` (stable LSD radix sort of uint64 keys with int32
values), :func:`scan_exclusive_sum` and :func:`scan_inclusive_max`.  Every
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

__all__ = ['build_suffix_array', 'derive_sa', 'derive_sa_plain',
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
    runs :func:`derive_sa` (B1b, then B2 from k = 6); ``'full'`` runs B9
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
            sa = derive_sa(text, n)[0][:n]
        else:
            sa = sa_full_doubling(text, n)[N - n:]
        return sa.cpu().numpy()


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
#: ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W).
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


def _byte_key(text: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [N]: the first 6 digits of every suffix, digit byte + 1 and 0
    at or past n, keyed as ``limb0 << 25 | limb1`` (three base-257 digits
    each, 257^3 < 2^25)."""
    iota = torch.arange(text.shape[0], device=text.device)
    e = torch.where(iota < n, text.long() + 1, 0)
    limbs = [torch.zeros_like(e), torch.zeros_like(e)]
    for d in range(BYTE_INIT_WIDTH):
        limbs[d // 3] = limbs[d // 3] * 257 + _shifted(e, d)
    return (limbs[0] << 25) | limbs[1]


def sa_init_bytes_plain(text: torch.Tensor, n: int):
    """Plain version of B1b: (sa, rank, gs) int32 [N] of the anchored init
    sort over the first 6 digits of every suffix (:func:`_byte_key`)."""
    return _init_from_key(_byte_key(text, n), n)


def sa_init_bytes(text: torch.Tensor, n: int):
    """B1b, the 6-byte anchored init sort of a padded uint8 [N] text row of
    true length ``n``: (sa, rank, gs) int32 [N] (see
    :func:`sa_init_bytes_plain`).  Replaces ``_init_round_anchored``; needs
    ``n + 6 <= N``."""
    N = text.shape[0]
    _check_pad_contract(N, n, None)
    if not kernels.route(text):
        return sa_init_bytes_plain(text, n)
    kernels.check(text, 'text', torch.uint8, 1)
    dev = text.device
    sa, rk, gs = (torch.empty(N, dtype=torch.int32, device=dev)
                  for _ in range(3))
    scratch = kernels.scratch('sa_init', N, dev)
    with torch.cuda.device(dev):
        kernels.launch('sa_init_bytes', text.data_ptr(), N, int(n),
                       sa.data_ptr(), rk.data_ptr(), gs.data_ptr(),
                       scratch.data_ptr())
    return sa, rk, gs


def _tied_plain(gs: torch.Tensor) -> torch.Tensor:
    """tied[slot]: slot's group has two or more members."""
    eq_next = torch.zeros(gs.shape[0], dtype=torch.bool, device=gs.device)
    eq_next[:-1] = gs[:-1] == gs[1:]
    tied = eq_next.clone()
    tied[1:] |= eq_next[:-1]
    return tied


def _round_keys(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                k: int):
    """A B2 round's (tied slots, their positions, their int64 keys
    ``gs << W | (rank[pos + k] + 1)``, 0 past the row) in slot order."""
    N = sa.shape[0]
    slots = torch.nonzero(_tied_plain(gs)).flatten()
    pos = sa[slots].long()
    q = pos + k
    r2 = torch.where(q < N, rank[q.clamp(max=N - 1)].long(), -1)
    return slots, pos, (gs[slots].long() << _key_width(N)) | (r2 + 1)


def sa_refine_round_plain(sa: torch.Tensor, rank: torch.Tensor,
                          gs: torch.Tensor, k: int) -> int:
    """Plain version of B2: refine every tied group by the rank ``k``
    positions on, in place; returns the tie count m."""
    slots, pos, key = _round_keys(sa, rank, gs, k)
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


def _derive(init_ranked, init_bytes, refine, roll, text, n, rank, bits,
            out):
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
    del rk, gs
    return roll(sa, n, out), ties


def derive_sa(text: torch.Tensor, n: int,
              rank: typing.Optional[torch.Tensor] = None,
              bits: typing.Optional[int] = None,
              out: typing.Optional[torch.Tensor] = None):
    """The SA of a padded uint8 [N] text row of true length ``n``, built on
    the row's device: (sa int32 [N] in the rolled-front layout of the JAX
    ``derive_sa``, the tie count m of every doubling round run).  With
    ``bits`` None, B1b and then B2 from k = 6 (``_derive_sa_seg_jit``);
    with a ranked alphabet's ``rank`` and ``bits``, B1 and then B2 from k =
    2 * (30 // bits) (``_derive_sa_seg_ranked_jit``).  The rounds double k
    while k < N and ties remain; the host reads each round's m once.
    ``out`` (a row of the stacked index) receives the SA when given."""
    return _derive(sa_init_ranked, sa_init_bytes, sa_refine_round,
                   sa_roll_front, text, n, rank, bits, out)


def derive_sa_plain(text: torch.Tensor, n: int,
                    rank: typing.Optional[torch.Tensor] = None,
                    bits: typing.Optional[int] = None,
                    out: typing.Optional[torch.Tensor] = None):
    """:func:`derive_sa` through the plain versions on any device."""
    return _derive(sa_init_ranked_plain, sa_init_bytes_plain,
                   sa_refine_round_plain, sa_roll_front_plain, text, n, rank,
                   bits, out)


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
