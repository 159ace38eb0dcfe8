"""Suffix-array construction, on the host and on the device.

Host: two backends, one contract (``uint8[n] -> int32[n]``), with the
ordering of the on-disk container: plain bytewise order where a proper
prefix sorts before any extension.

- ``native``: the C++ SA-IS kernel in ``native/sais.cpp`` (:mod:`.native`);
- ``numpy``: host prefix doubling, the ground truth for tests.

The SA of a string is unique, so both give identical bytes.

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
- :func:`sa_refine_round` (B2): one doubling round over the tied slots.

Their building blocks are kernels of the same file, exposed for tests:
:func:`radix_sort_pairs` (stable LSD radix sort of uint64 keys with int32
values), :func:`scan_exclusive_sum` and :func:`scan_inclusive_max`.  Every
wrapper takes its plain version only for CPU tensors; on a CUDA tensor it
launches its kernel or raises.  The kernel sorts and the plain sorts are
both stable and see positions in slot order, so on the card they agree bit
for bit.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from . import kernels

__all__ = ['build_suffix_array', 'derive_sa', 'derive_sa_plain',
           'suffix_array_numpy']


def suffix_array_numpy(data: np.ndarray) -> np.ndarray:
    """Prefix-doubling SA on the host; ground truth for the native kernel."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    rank = data.astype(np.int64)
    order = np.argsort(rank, kind='stable').astype(np.int64)
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


def build_suffix_array(data: np.ndarray, backend: str = 'auto') -> np.ndarray:
    """Suffix array of ``data`` (uint8).  ``auto`` is the native SA-IS, or
    numpy where no C++ compiler could build it."""
    data = np.asarray(data, dtype=np.uint8)
    from . import native

    if backend == 'numpy' or (backend == 'auto' and not native.available()):
        return suffix_array_numpy(data)
    if backend in ('native', 'auto'):
        return native.suffix_array_native(data)
    raise ValueError(f'unknown suffix-array backend: {backend!r}')


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
#: over at most every slot (36).
SA_BUILD_BYTES_PER_SLOT = 56


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


def sa_init_ranked_plain(text: torch.Tensor, n: int, rank: torch.Tensor,
                         bits: int):
    """Plain version of B1: (sa, rank, gs) int32 [N] of the anchored init
    sort over the first 2D rank digits of every suffix (D = 30 // bits)."""
    iota = torch.arange(text.shape[0], device=text.device)
    e = torch.where(iota < n, rank.long()[text.long()], 0)
    key = torch.zeros_like(e)
    for d in range(2 * (30 // bits)):
        key = (key << bits) | _shifted(e, d)
    return _init_from_key(key, n)


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


def sa_init_bytes_plain(text: torch.Tensor, n: int):
    """Plain version of B1b: (sa, rank, gs) int32 [N] of the anchored init
    sort over the first 6 digits of every suffix, digit byte + 1 and 0 at
    or past n, keyed as ``limb0 << 25 | limb1`` (three base-257 digits
    each, 257^3 < 2^25)."""
    iota = torch.arange(text.shape[0], device=text.device)
    e = torch.where(iota < n, text.long() + 1, 0)
    limbs = [torch.zeros_like(e), torch.zeros_like(e)]
    for d in range(BYTE_INIT_WIDTH):
        limbs[d // 3] = limbs[d // 3] * 257 + _shifted(e, d)
    return _init_from_key((limbs[0] << 25) | limbs[1], n)


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


def sa_refine_round_plain(sa: torch.Tensor, rank: torch.Tensor,
                          gs: torch.Tensor, k: int) -> int:
    """Plain version of B2: refine every tied group by the rank ``k``
    positions on, in place; returns the tie count m."""
    N = sa.shape[0]
    slots = torch.nonzero(_tied_plain(gs)).flatten()
    m = slots.shape[0]
    if m == 0:
        return 0
    pos = sa[slots].long()
    g = gs[slots].long()
    q = pos + k
    r2 = torch.where(q < N, rank[q.clamp(max=N - 1)].long(), -1)
    key = (g << _key_width(N)) | (r2 + 1)
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
