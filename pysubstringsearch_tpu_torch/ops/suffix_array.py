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
  digits; both split their keys at the top bits (the hybrid path:
  :func:`bucket_split_plain`, :func:`large_buckets_plain`,
  :func:`large_bucket_keys_plain`, :func:`bucket_sort_plain`) unless most
  slots would land in large buckets;
- :func:`sa_round` (B2): one doubling round over the tied slots of a
  candidate list, the last round's (:func:`sa_refine_round` over the whole
  row), as a segmented sort of the already ordered groups;
- :func:`sa_init3_bytes`, :func:`sa_window_scan` and
  :func:`sa_rotating_pass` (B10): the 3-byte init and the windowed passes
  of the rotating doubler;
- :func:`sa_full_init_bytes`, :func:`sa_full_init_int` and
  :func:`sa_full_round` (B9): prefix doubling with dense ranks, the JAX
  ``_doubling_kernel`` and ``_int_doubling_kernel``, until the real slots
  are distinct, the pad slots then written in closed form
  (:func:`suffix_array_device` is the JAX name over it);
- :func:`giant_byte_keys`, :func:`giant_round_keys`, :func:`giant_cuts`,
  :func:`giant_partition`, :func:`giant_merge`, :func:`giant_flags` and
  :func:`giant_relabel` (B14g): the per-shard steps of B9 split over a
  mesh (``parallel/sharded.py``).

The Writer's device build (:func:`build_suffix_array` with ``'torch'``, or
``'auto'`` on a CUDA card where :func:`_device_build_worthwhile` finds it
faster than native SA-IS) runs :func:`suffix_array_torch`, and
:func:`suffix_array_int` builds over an integer alphabet.  The routing
constants live here too: :func:`host_device_link_mbps`,
:func:`device_rtt_estimate` and the two build rates.

Their building blocks are kernels of the same file, exposed for tests:
:func:`radix_sort_pairs` (stable LSD radix sort of uint64 keys with int32
values) and :func:`scan_exclusive_sum`; and :func:`scatter` (B16) is the radix sort's store pass alone
(:func:`scatter_blocked` the same blocked by destination).  Every
wrapper takes its plain version only for CPU tensors; on a CUDA tensor it
launches its kernel or raises.  The kernel sorts and the plain sorts are
both stable and see positions in slot order, so on the card they agree bit
for bit.
"""

from __future__ import annotations

import os
import threading
import time
import typing

import numpy as np
import torch

from . import kernels

__all__ = ['build_suffix_array', 'derive_sa', 'derive_sa_full',
           'derive_sa_plain', 'device_rtt_estimate', 'host_device_link_mbps',
           'segmented_rotating_sa', 'segmented_sa', 'suffix_array_device',
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


#: Below this many bytes ``'auto'`` never builds on the card (the JAX
#: package's ``_JAX_MIN_N``).
DEVICE_MIN_N = 1 << 16

#: Serialises the device part of every build, so the Writer's concurrent
#: workers neither add up their memory peaks nor interleave their rounds.
_DEVICE_BUILD_LOCK = threading.Lock()

# ---------------------------------------------------------------------------
# Routing constants: the link, the device round trip, the build rates
# ---------------------------------------------------------------------------

#: (H2D, D2H) MB/s of the CUDA card, cached by :func:`host_device_link_mbps`.
_LINK_RATES: typing.Optional[typing.Tuple[float, float]] = None

#: (H2D, D2H) MB/s that ``host_device_link_mbps(probe=False)`` returns when
#: nothing is cached: one 4 MB transfer each way between numpy and the
#: card, as :func:`host_device_link_mbps` measures it at a Reader's load,
#: in chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (2026-10-18).
LINK_MBPS_DEFAULT = (5592.0, 6354.0)

#: Seconds of a 1-pattern ``DeviceIndex.probe``, cached by
#: :func:`device_rtt_estimate`.
_DEVICE_RTT: typing.Optional[float] = None

#: The round trip :func:`device_rtt_estimate` returns on CUDA before one
#: was measured: chip_smoke.py's 1-pattern probe of its ranked derive
#: index at load (the fastest of 3), NVIDIA H100 80GB HBM3 at 700.00 W
#: (2026-10-18).
DEVICE_RTT_DEFAULT_S = 1.18e-4

#: Planning rates of the auto backend (MB/s of text), env-tunable.  The
#: device rate is B1b + B2 on an 8 MiB chunk of chip_smoke.py's ranked
#: corpus (2.873 ms), device time only (the link terms are added apart);
#: the native rate one ``native.suffix_array_native`` call on the same
#: chunk (0.457 s); both on an NVIDIA H100 80GB HBM3 at 700.00 W and its
#: host (2026-10-18).
_DEVICE_BUILD_MBPS = float(os.environ.get('TPUSS_DEVICE_BUILD_MBPS', '2919'))
_NATIVE_BUILD_MBPS = float(os.environ.get('TPUSS_NATIVE_BUILD_MBPS',
                                          '18.35'))


def host_device_link_mbps(device: typing.Union[str, torch.device] = 'cuda',
                          probe: bool = True) -> typing.Tuple[float, float]:
    """(H2D, D2H) MB/s between the host and ``device``, measured once per
    process: a throwaway 1 KiB round trip, then one 4 MB ``torch`` copy
    from numpy to the card and one back to numpy, the result cached.  A
    device build ships the text up and the SA down, and the Reader's
    device extraction reads 4 bytes a hit back, so the link, not the
    kernels, can decide a route.  ``TPUSS_LINK_MBPS=h2d,d2h`` overrides
    (and is cached) without measuring; a CPU ``device`` moves nothing and
    reports ``(inf, inf)``.  ``probe=False`` never transfers: it returns
    the cached rates, else ``LINK_MBPS_DEFAULT``."""
    global _LINK_RATES
    if _LINK_RATES is not None:
        return _LINK_RATES
    override = os.environ.get('TPUSS_LINK_MBPS')
    if override:
        h2d_s, d2h_s = override.split(',')
        _LINK_RATES = (float(h2d_s), float(d2h_s))
        return _LINK_RATES
    dev = torch.device(device)
    if dev.type == 'cpu':
        return (float('inf'), float('inf'))
    if not probe:
        return LINK_MBPS_DEFAULT
    torch.zeros(1024, dtype=torch.uint8).to(dev).cpu()
    mb = 4.0
    host = np.zeros(int(mb * 1e6), dtype=np.uint8)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    up = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize(dev)
    h2d = mb / max(time.perf_counter() - t0, 1e-9)
    down = torch.zeros(host.size, dtype=torch.uint8, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    down.cpu().numpy()
    d2h = mb / max(time.perf_counter() - t0, 1e-9)
    del up, down
    _LINK_RATES = (h2d, d2h)
    return _LINK_RATES


def device_rtt_estimate(device: typing.Union[str, torch.device] = 'cuda',
                        index=None) -> float:
    """Seconds of the fixed cost every device probe pays: the round trip of
    a 1-pattern ``DeviceIndex.probe`` (upload, launch, readback).  The
    Reader sends a batch to the host bisection when the host's estimate is
    below it.  0 on the CPU, where the tests keep exercising the device
    path; ``TPUSS_DEVICE_RTT`` (seconds) overrides it on CUDA.  Given a
    built CUDA ``index`` and nothing cached, it measures the probe once
    (the fastest of three) and caches it; before that it returns
    ``DEVICE_RTT_DEFAULT_S``."""
    global _DEVICE_RTT
    if torch.device(device).type == 'cpu':
        return 0.0
    override = os.environ.get('TPUSS_DEVICE_RTT')
    if override:
        return float(override)
    if _DEVICE_RTT is None and index is not None:
        pats = np.full((1, 4), ord('e'), dtype=np.uint8)
        lens = np.full((1,), 4, dtype=np.int32)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            index.probe(pats, lens)
            times.append(time.perf_counter() - t0)
        _DEVICE_RTT = min(times)
    return DEVICE_RTT_DEFAULT_S if _DEVICE_RTT is None else _DEVICE_RTT


def _device_build_worthwhile(n: int) -> bool:
    """Whether text up + the card's build + SA down beats native SA-IS for
    an n-byte chunk, at the cached (or default) link rates."""
    h2d, d2h = host_device_link_mbps(probe=False)
    mb = n / 1e6
    device_s = mb / h2d + mb / _DEVICE_BUILD_MBPS + 4.0 * mb / d2h
    native_s = mb / _NATIVE_BUILD_MBPS
    return device_s < native_s


def build_suffix_array(data: np.ndarray, backend: str = 'auto') -> np.ndarray:
    """Suffix array of ``data`` (uint8) with the chosen backend:
    ``'native'`` (C++ SA-IS), ``'numpy'``, ``'torch'``
    (:func:`suffix_array_torch` on the CUDA card; raises without one), or
    ``'auto'``, the JAX rule: native SA-IS for a chunk under
    ``DEVICE_MIN_N`` bytes, without CUDA, or where
    :func:`_device_build_worthwhile` finds the card slower; else the card
    (numpy where no C++ compiler could build the native kernel)."""
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
    cuda = torch.cuda.is_available()
    if native.available() and (
        data.size < DEVICE_MIN_N
        or not cuda
        or not _device_build_worthwhile(data.size)
    ):
        return native.suffix_array_native(data)
    if data.size >= DEVICE_MIN_N and cuda:
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
        sa_full = sa_full_doubling_int(torch.from_numpy(padded).to(dev), n)
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
    with kernels.on(keys.device):
        kernels.launch('radix_sort_pairs', keys.data_ptr(), vals.data_ptr(),
                       n, key_bits, scratch.data_ptr())
    return keys, vals


#: B16's geometry, as ``csrc/suffix_array_kernels.cu`` fixes it: the
#: slots of one bin (a cluster of two blocks assembles it in shared
#: memory), the pairs of one distribute tile, and the slots one pass of
#: bins covers (a larger ``out`` takes a pass a window of that many
#: slots).  The tests probe the kernel's edges with them.
SCATTER_BIN_SLOTS = 1 << 16
SCATTER_TILE = 16384
SCATTER_PASS_SLOTS = 1 << 29


def scatter_plain(values: typing.Optional[torch.Tensor], dests: torch.Tensor,
                  out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``out[dests] = values`` (values None: each dest's
    index, ``out[dests[i]] = i``), into a new tensor like ``dests`` when
    ``out`` is not given; a dest outside ``out`` (negative, or past its
    end) is dropped, as the kernel drops it."""
    if out is None:
        out = torch.empty_like(dests)
    if values is None:
        values = torch.arange(dests.shape[0], dtype=torch.int32,
                              device=dests.device)
    d = dests.long()
    inside = (d >= 0) & (d < out.shape[0])
    if not bool(inside.all()):
        d, values = d[inside], values[inside]
    out[d] = values
    return out


def scatter(values: typing.Optional[torch.Tensor], dests: torch.Tensor,
            out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """B16, the store pass of an LSD radix sort: ``out[dests[i]] =
    values[i]`` for int32 [n] ``values`` and ``dests``, into int32 ``out``
    (a new [n] tensor when not given); with ``values`` None each dest
    takes its own index i (the giant build's finish stores positions by
    slot so, reading no values).  Replaces ``pallas_scatter``
    (``benchmarks/pallas_sort_bench.py``); the giant build's rank store
    runs it.  The caller's contract, as in that benchmark, which scatters
    by a permutation: the dests are distinct; the card does not check it.
    A dest outside ``out`` is dropped (the giant build's finish drops its
    unsettled positions so), and a slot no dest names keeps what ``out``
    held.
    Any n: the JAX kernel's multiple of 8192 was the tile of its VMEM
    blocks, not a property of the function.  On the card a binned store
    (``SCATTER_BIN_SLOTS``): count by bin, distribute the pairs into an 8
    bytes a pair scratch in bin order, assemble each bin in shared memory
    and write it whole; one counted launch."""
    if out is None:
        out = torch.empty_like(dests)
    given = () if values is None else (values,)
    if not kernels.route(dests, out, *given):
        return scatter_plain(values, dests, out)
    for t, name in ((dests, 'dests'), (out, 'out')) + tuple(
            (v, 'values') for v in given):
        kernels.check(t, name, torch.int32, 1)
    n = dests.shape[0]
    if values is not None and values.shape[0] != n:
        raise ValueError('scatter: values and dests differ in length')
    with kernels.on(dests.device):
        scratch = kernels.scratch('scatter', n, dests.device)
        kernels.launch('scatter',
                       None if values is None else values.data_ptr(),
                       dests.data_ptr(), n, out.data_ptr(), out.shape[0],
                       scratch.data_ptr())
    return out


def scatter_blocked(values: torch.Tensor, dests: torch.Tensor,
                    out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`scatter` blocked by destination: the pairs are first
    partitioned by the top 8 bits of their dests with one one-sweep pass,
    then stored bin by bin, so that a bin's stores meet in L2.  Same
    contract and plain version as :func:`scatter`; ``sort_bench`` measures
    it beside the binned store; the anchored inits store their ranks the
    same way in their own kernels."""
    if out is None:
        out = torch.empty_like(values)
    if not kernels.route(values, dests, out):
        return scatter_plain(values, dests, out)
    for t, name in ((values, 'values'), (dests, 'dests'), (out, 'out')):
        kernels.check(t, name, torch.int32, 1)
    n = values.shape[0]
    if dests.shape[0] != n:
        raise ValueError('scatter_blocked: values and dests differ in length')
    with kernels.on(values.device):
        scratch = kernels.scratch('scatter_blocked', n, values.device)
        kernels.launch('scatter_blocked', values.data_ptr(), dests.data_ptr(),
                       n, out.data_ptr(), scratch.data_ptr())
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
    with kernels.on(x.device):
        kernels.launch('scan_exclusive_sum', x.data_ptr(), out.data_ptr(), n,
                       scratch.data_ptr())
    return out


# ---------------------------------------------------------------------------
# B1 and B2: the device SA build
# ---------------------------------------------------------------------------

#: Device bytes one row's SA build holds per padded slot at its peak, on
#: top of the row's text and SA: the working sa / rank / gs (12), and the
#: init's (key, position) pairs and their double buffers with its list of
#: up to N / 4 large members and the one-sweep sort's status words (28.5),
#: or a round's tied list (4) with its refine's buffers over at most every
#: slot (32.5).  The largest peaks measured (``chip_smoke.py`` on an NVIDIA
#: H100 80GB HBM3 at 700 W): the digit derive 12.13 GiB above the index for
#: a 256 Mi-slot row (48.5 bytes a slot, its SA output included), B1b + B2
#: on one 512 Mi row 23.77 GiB (47.5), B9 after a poisoned B10 18.49 GiB at
#: 416 Mi (45.5), B10 8.25 GiB at 512 Mi (16.5, ``sa_bench.py``: its init,
#: which sorts inside its outputs, then its passes at 7.64 GiB); a round
#: over every slot could reach 48.5, and the constant keeps headroom over
#: it.
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


#: The anchored inits' key widths: B1's 2D digits of ``bits`` bits (60 for
#: both 5 and 6), B1b's two 25-bit limbs.
RANKED_KEY_BITS = 60
BYTE_KEY_BITS = 50

#: The top key bits the hybrid init sorts by before its bucket stages
#: (``csrc``'s kCutRanked, kCutBytes).  Set from the buckets of the
#: derive rows measured on an H100 (PERF.md §6): at 24 bits 0.9% of the
#: ranked row's slots lie in buckets of more than ``SEG_T`` members, the
#: raw row's 35% (0.7% at 32).
INIT_CUT_RANKED = 24
INIT_CUT_BYTES = 32


def _init_launch(name: str, text: torch.Tensor, n: int, extra: tuple,
                 stats: typing.Optional[torch.Tensor]):
    """sa, rank, gs int32 [N] of the hybrid init ``name`` (B1 or B1b) on
    the card; ``extra`` are the arguments between n and the outputs."""
    if stats is not None:
        kernels.check(stats, 'stats', torch.int32, 1)
        if stats.shape[0] != 3 or stats.device != text.device:
            raise ValueError(f'{name}: stats must be int32 [3] on the '
                             'text\'s device')
    N = text.shape[0]
    dev = text.device
    sa, rk, gs = (torch.empty(N, dtype=torch.int32, device=dev)
                  for _ in range(3))
    with kernels.on(dev):
        scratch = kernels.scratch('sa_hybrid', N, dev)
        kernels.launch(name, text.data_ptr(), N, int(n), *extra,
                       sa.data_ptr(), rk.data_ptr(), gs.data_ptr(),
                       scratch.data_ptr(),
                       None if stats is None else stats.data_ptr())
    return sa, rk, gs


def sa_init_ranked(text: torch.Tensor, n: int, rank: torch.Tensor,
                   bits: int, *,
                   stats: typing.Optional[torch.Tensor] = None):
    """B1, the anchored init sort of a padded uint8 [N] text row of true
    length ``n`` with the byte -> rank map ``rank`` int32 [256]: (sa, rank,
    gs) int32 [N] (see :func:`sa_init_ranked_plain`).  Replaces
    ``_init_round_anchored_ranked``; needs ``n + 30 // bits <= N``.  On
    the card the device picks the hybrid path (the top ``INIT_CUT_RANKED``
    key bits, then bucket sorts) or a full sort of the key, and ``stats``
    (int32 [3] on the card) receives the path taken (1 hybrid, 2 full, 3
    full after too many large members), the estimated and the counted
    large members."""
    N = text.shape[0]
    _check_pad_contract(N, n, bits)
    if not kernels.route(text, rank):
        return sa_init_ranked_plain(text, n, rank, bits)
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(rank, 'rank', torch.int32, 1)
    if rank.shape[0] != 256:
        raise ValueError('sa_init_ranked: rank must have 256 entries')
    return _init_launch('sa_init_ranked', text, n, (rank.data_ptr(), bits),
                        stats)


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


def sa_init_bytes(text: torch.Tensor, n: int, *,
                  stats: typing.Optional[torch.Tensor] = None):
    """B1b, the 6-byte anchored init sort of a padded uint8 [N] text row of
    true length ``n``: (sa, rank, gs) int32 [N] (see
    :func:`sa_init_bytes_plain`).  Replaces ``_init_round_anchored``; needs
    ``n + 6 <= N``.  ``stats`` as in :func:`sa_init_ranked`, the hybrid
    path cutting at ``INIT_CUT_BYTES`` bits."""
    _check_pad_contract(text.shape[0], n, None)
    return _init_bytes(text, n, 'sa_init_bytes', BYTE_INIT_WIDTH, stats)


def _init_bytes(text: torch.Tensor, n: int, name: str, width: int,
                stats: typing.Optional[torch.Tensor] = None):
    """The anchored init on ``width`` byte digits by the kernel ``name``
    (B1b's hybrid init at 6, B10's full sort at 3), on any ``0 <= n <= N``:
    the keys mask every read at n, so the pad positions are exactly the
    all-zero key group without a margin."""
    N = text.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f'{name}: need 0 <= n <= N, got n={n}, N={N}')
    if not kernels.route(text):
        return _init_from_key(_byte_key(text, n, width), n)
    kernels.check(text, 'text', torch.uint8, 1)
    if width == BYTE_INIT_WIDTH:
        return _init_launch(name, text, n, (), stats)
    dev = text.device
    sa, rk, gs = (torch.empty(N, dtype=torch.int32, device=dev)
                  for _ in range(3))
    scratch = kernels.scratch('sa_init', N, dev)
    with kernels.on(dev):
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
    slot order: what the JAX round sorts."""
    N = sa.shape[0]
    if marked is None:
        marked = _tied_plain(gs)
    slots = torch.nonzero(marked).flatten()
    pos = sa[slots].long()
    return slots, pos, (gs[slots].long() << _key_width(N)) | _r2_plus1(
        rank, pos, k)


def _r2_plus1(rank: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """int64 rank[pos + k] + 1, 0 past the row."""
    N = rank.shape[0]
    q = pos.long() + k
    return torch.where(q < N, rank[q.clamp(max=N - 1)].long(), -1) + 1


#: B2's small-group bound: a tied group of at most this many members is
#: refined without a global sort (by counting its members up to 32, by a
#: block's shared-memory radix sort above), a larger one by the one-sweep
#: sort on its (large-group ordinal, r2 + 1) key (``csrc``'s kSegT).  Set
#: from round 1's group sizes on the chip corpora (PERF.md §5): groups of
#: 2048-4095 members hold 56% of the raw row's tied slots, and a block of
#: 512 threads holds 2 x SEG_T members in registers and 80 KB of shared
#: memory.
SEG_T = 4096


def tie_list_plain(gs: torch.Tensor,
                   cand: typing.Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """B2's carried list: int32 [m], the tied slots (``_tied_flags`` of
    ``gs``) in slot order, taken from the candidate slots ``cand`` (the
    last round's list; every slot when None)."""
    tied = _tied_plain(gs)
    if cand is None:
        return torch.nonzero(tied).flatten().to(torch.int32)
    cand = cand.long()
    return cand[tied[cand]].to(torch.int32)


def split_groups_plain(gs: torch.Tensor, tl: torch.Tensor,
                       seg_t: int = SEG_T) -> torch.Tensor:
    """bool [m]: list member t lies in a large group, one of more than
    ``seg_t`` members (slot ``g + seg_t`` still has group start g)."""
    N = gs.shape[0]
    g = gs[tl.long()].long()
    q = g + seg_t
    return (q < N) & (gs[q.clamp(max=N - 1)].long() == g)


def large_keys_plain(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                     tl: torch.Tensor, large: torch.Tensor, k: int,
                     seg_t: int = SEG_T) -> torch.Tensor:
    """int64 keys of the large members in list order: (the member's group
    start in the large list >> log2 ``seg_t``) << W | (r2 + 1).  Each large
    group has more than ``seg_t`` members, so the ordinals of two groups
    differ, and the key orders as (g, r2) does on W + log2(m / seg_t) bits
    instead of 2W."""
    if seg_t & (seg_t - 1):
        raise ValueError('large_keys_plain: seg_t must be a power of two')
    s = tl.long()[large]
    j = torch.arange(s.shape[0], device=s.device)
    lstart = j - (s - gs[s].long())
    return ((lstart >> (seg_t.bit_length() - 1)) << _key_width(
        gs.shape[0])) | _r2_plus1(rank, sa[s], k)


def refine_list_plain(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                      k: int, tl: torch.Tensor, seg_t: int = SEG_T) -> None:
    """B2's refine of the listed slots ``tl`` (whole groups, slot order) by
    the rank ``k`` positions on, in place, as the card splits it: the small
    groups sorted by (g, r2) among themselves, the large ones by
    :func:`large_keys_plain`; then every member's new label is the slot of
    the first member with its (g, r2)."""
    m = tl.shape[0]
    if m == 0:
        return
    t = tl.long()
    pos = sa[t].long()
    full = (gs[t].long() << _key_width(sa.shape[0])) | _r2_plus1(rank, pos,
                                                                 k)
    large = split_groups_plain(gs, tl, seg_t)
    perm = torch.empty(m, dtype=torch.int64, device=sa.device)
    for sel, key in ((~large, full[~large]),
                     (large, large_keys_plain(sa, rank, gs, tl, large, k,
                                              seg_t))):
        where = torch.nonzero(sel).flatten()
        perm[where] = where[torch.sort(key, stable=True)[1]]
    key_s, pos_s = full[perm], pos[perm]
    change = torch.ones(m, dtype=torch.bool, device=sa.device)
    change[1:] = key_s[1:] != key_s[:-1]
    first_eq = torch.cummax(torch.where(change, t, 0), 0).values
    first_eq = first_eq.to(torch.int32)
    sa[t] = pos_s.to(torch.int32)
    rank[pos_s] = first_eq
    gs[t] = first_eq


def bucket_split_plain(key: torch.Tensor, n: int, key_bits: int, cut: int):
    """The hybrid init's first stage: the positions of int64 [N] ``key``
    stably sorted by the top ``cut`` of the keys' ``key_bits`` bits alone,
    as its top passes leave them: (the keys int64 [N] in that order, their
    positions int64 [N], bs int64 [N] the start slot of every slot's
    bucket).  The pad positions (key 0, past ``n``) come first, each a
    bucket of its own."""
    N = key.shape[0]
    top_s, order = torch.sort(key >> (key_bits - cut), stable=True)
    iota = torch.arange(N, device=key.device)
    start = iota <= N - n
    start[1:] |= top_s[1:] != top_s[:-1]
    return key[order], order, torch.cummax(torch.where(start, iota, 0),
                                           0).values


def large_buckets_plain(bs: torch.Tensor,
                        seg_t: int = SEG_T) -> torch.Tensor:
    """bool [N]: each slot's bucket, from the bucket starts ``bs``, has
    more than ``seg_t`` members (the large path); a bucket of at most
    ``seg_t`` is sorted in one block's shared memory, a single member or a
    pad slot included."""
    return torch.bincount(bs, minlength=bs.shape[0])[bs] > seg_t


def large_bucket_keys_plain(keys_s: torch.Tensor, bs: torch.Tensor,
                            large: torch.Tensor, low: int,
                            seg_t: int = SEG_T) -> torch.Tensor:
    """int64 keys of the large buckets' members in slot order: (the
    member's bucket start in the list of large members >> log2 ``seg_t``)
    << ``low`` | its low ``low`` key bits.  Each large bucket has more than
    ``seg_t`` members, so two buckets' ordinals differ, and the key orders
    as (bucket, low bits) does."""
    if seg_t & (seg_t - 1):
        raise ValueError('large_bucket_keys_plain: seg_t must be a power of '
                         'two')
    s = torch.nonzero(large).flatten()
    lstart = torch.arange(s.shape[0], device=s.device) - (s - bs[s])
    return ((lstart >> (seg_t.bit_length() - 1)) << low) | (
        keys_s[s] & ((1 << low) - 1))


def bucket_sort_plain(keys_s: torch.Tensor, order: torch.Tensor,
                      bs: torch.Tensor, n: int, low: int,
                      seg_t: int = SEG_T):
    """The hybrid init's bucket stages on :func:`bucket_split_plain`'s
    output: each bucket's members sorted stably by their low ``low`` key
    bits, the buckets of at most ``seg_t`` among themselves, the large ones
    by :func:`large_bucket_keys_plain`; pad slots i < N - n hold N - 1 - i.
    Returns (sa, rank, gs) int32 [N]: each slot's label is the first slot
    of its run of equal keys, and rank[sa[i]] = gs[i]."""
    N = keys_s.shape[0]
    dev = keys_s.device
    is_large = large_buckets_plain(bs, seg_t)
    lowk = keys_s & ((1 << low) - 1)
    perm = torch.empty(N, dtype=torch.int64, device=dev)
    small = torch.nonzero(~is_large).flatten()
    # (bucket, low bits) in two stable sorts: the pair can pass 63 bits.
    by_low = small[torch.sort(lowk[small], stable=True)[1]]
    perm[small] = by_low[torch.sort(bs[by_low], stable=True)[1]]
    large = torch.nonzero(is_large).flatten()
    perm[large] = large[torch.sort(large_bucket_keys_plain(
        keys_s, bs, is_large, low, seg_t), stable=True)[1]]
    key_s = keys_s[perm]
    iota = torch.arange(N, device=dev)
    npad = N - n
    sa = torch.where(iota < npad, N - 1 - iota, order[perm])
    start = iota <= npad
    start[1:] |= key_s[1:] != key_s[:-1]
    gs = torch.cummax(torch.where(start, iota, 0), 0).values
    rk = torch.empty(N, dtype=torch.int64, device=dev)
    rk[sa] = gs
    return sa.to(torch.int32), rk.to(torch.int32), gs.to(torch.int32)


def sa_round_plain(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                   k: int, cand: typing.Optional[torch.Tensor] = None,
                   seg_t: int = SEG_T):
    """Plain version of :func:`sa_round`."""
    tl = tie_list_plain(gs, cand)
    refine_list_plain(sa, rank, gs, k, tl, seg_t)
    return tl.shape[0], tl


def sa_round(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor, k: int,
             cand: typing.Optional[torch.Tensor] = None):
    """B2, one tie-only doubling round on int32 [N] (sa, rank, gs), in
    place, over the candidate slots ``cand`` (the last round's list, or
    every slot when None): returns (m, the round's tied list int32 [m]),
    the next round's candidates, since groups only split.  Two launches:
    ``sa_tie_scan`` (the list and its count m, read back once) and
    ``sa_refine_round`` (the segmented sort: groups of at most ``SEG_T``
    members in shared memory, larger ones by the one-sweep sort).  Replaces
    the body of ``_segmented_loop`` with ``_tied_flags`` and
    ``_relabel_and_scatter``."""
    if cand is None:
        on_card = kernels.route(sa, rank, gs)
    else:
        on_card = kernels.route(sa, rank, gs, cand)
    if not on_card:
        return sa_round_plain(sa, rank, gs, k, cand)
    for t, name in ((sa, 'sa'), (rank, 'rank'), (gs, 'gs')):
        kernels.check(t, name, torch.int32, 1)
    N = sa.shape[0]
    if rank.shape[0] != N or gs.shape[0] != N:
        raise ValueError('sa_round: sa, rank and gs differ in length')
    if cand is not None:
        kernels.check(cand, 'cand', torch.int32, 1)
    c = N if cand is None else cand.shape[0]
    dev = sa.device
    tl = torch.empty(c, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    with kernels.on(dev):
        scratch = kernels.scratch('sa_round', c, dev)
        kernels.launch('sa_tie_scan', gs.data_ptr(), N,
                       None if cand is None else cand.data_ptr(), c,
                       tl.data_ptr(), counts.data_ptr(), scratch.data_ptr())
        m = int(counts[0])
        del scratch
        if m:
            scratch = kernels.scratch('sa_refine', m, dev)
            kernels.launch('sa_refine_round', sa.data_ptr(), rank.data_ptr(),
                           gs.data_ptr(), N, int(k), m, tl.data_ptr(),
                           counts.data_ptr(), scratch.data_ptr())
    return m, tl[:m]


def sa_refine_round_plain(sa: torch.Tensor, rank: torch.Tensor,
                          gs: torch.Tensor, k: int) -> int:
    """Plain version of B2: refine every tied group by the rank ``k``
    positions on, in place; returns the tie count m."""
    return sa_round_plain(sa, rank, gs, k)[0]


def sa_refine_round(sa: torch.Tensor, rank: torch.Tensor, gs: torch.Tensor,
                    k: int) -> int:
    """B2, one tie-only doubling round over every slot of the row:
    :func:`sa_round` without a candidate list; returns the tie count m."""
    return sa_round(sa, rank, gs, k)[0]


def tie_group_histogram(gs: torch.Tensor) -> typing.Dict[str, list]:
    """The tied groups of ``gs`` by size class, ``{class: [groups,
    slots]}`` for 2, 3-16, 17-256, 257-4096 and above 4096 members, from
    one ``torch.unique_consecutive`` on ``gs``'s device."""
    g = gs[_tied_plain(gs)]
    _, sizes = torch.unique_consecutive(g, return_counts=True)
    sizes = sizes.long()
    out = {}
    for name, lo, hi in (('2', 2, 2), ('3-16', 3, 16), ('17-256', 17, 256),
                         ('257-4096', 257, 4096), ('>4096', 4097, None)):
        sel = sizes >= lo if hi is None else (sizes >= lo) & (sizes <= hi)
        out[name] = [int(sel.sum()), int(sizes[sel].sum())]
    return out


def bucket_histogram(key: torch.Tensor, key_bits: int,
                     cut: int) -> typing.Dict[str, list]:
    """An anchored init's buckets by size class: the real positions' keys
    (the pad positions' are 0) grouped by their top ``cut`` of
    ``key_bits`` bits, ``{class: [buckets, slots]}`` for 1, 2-32, 33-4096
    and above 4096 members, on ``key``'s device."""
    top = torch.sort(key[key != 0] >> (key_bits - cut)).values
    _, sizes = torch.unique_consecutive(top, return_counts=True)
    sizes = sizes.long()
    out = {}
    for name, lo, hi in (('1', 1, 1), ('2-32', 2, 32), ('33-4096', 33, 4096),
                         ('>4096', 4097, None)):
        sel = sizes >= lo if hi is None else (sizes >= lo) & (sizes <= hi)
        out[name] = [int(sel.sum()), int(sizes[sel].sum())]
    return out


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
    with kernels.on(sa_full.device):
        kernels.launch('sa_roll_front', sa_full.data_ptr(), N, int(n),
                       out.data_ptr())
    return out


def _segmented(init_ranked, init_bytes, round_fn, text, n, rank, bits):
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
    cand = None  # every slot, then the last round's tied list
    while k < N:
        m, cand = round_fn(sa, rk, gs, k, cand)
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
    ties remain; the host reads each round's m once.  Each round after the
    first reads only the last round's tied list (:func:`sa_round`)."""
    return _segmented(sa_init_ranked, sa_init_bytes, sa_round, text, n, rank,
                      bits)


def segmented_sa_plain(text: torch.Tensor, n: int,
                       rank: typing.Optional[torch.Tensor] = None,
                       bits: typing.Optional[int] = None,
                       seg_t: int = SEG_T):
    """:func:`segmented_sa` through the plain versions on any device, with
    the small-group bound ``seg_t``."""
    def round_fn(sa, rk, gs, k, cand):
        return sa_round_plain(sa, rk, gs, k, cand, seg_t)

    return _segmented(sa_init_ranked_plain, sa_init_bytes_plain, round_fn,
                      text, n, rank, bits)


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


def _window_span(N: int) -> int:
    """L, the slots a window's marks cover from its offset: a marked slot
    has its group start g in [off, off + W) and a member offset below
    S // 2, so it lies in [off, off + W + S // 2), cut at the row's end."""
    half, W = _rotating_sizes(N)
    return min(N, W + half)


def _span_mask(flags: torch.Tensor, off: int, N: int) -> torch.Tensor:
    """The whole row's bool [N] marks of a window's span flags (slot off +
    t for flags[t])."""
    mask = torch.zeros(N, dtype=torch.bool, device=flags.device)
    end = min(N, off + flags.shape[0])
    mask[off:end] = flags[: end - off].bool()
    return mask


def sa_init3_bytes_plain(text: torch.Tensor, n: int):
    """Plain version of B10's init: (sa, rank, gs) int32 [N] of the
    anchored init sort over the first 3 digits of every suffix."""
    return _init_from_key(_byte_key(text, n, 3), n)


def sa_init3_bytes(text: torch.Tensor, n: int):
    """B10's 3-byte anchored init of a uint8 [N] text row of true length
    ``0 <= n <= N`` (no margin needed): (sa, rank, gs) int32 [N], k covered
    = 3.  The full path's steps of B1b: one (key, position) radix sort on
    25 key bits, its groups and the binned rank store, sorting 32-bit keys
    inside the three outputs, so that its scratch is about 4.5 bytes a slot
    (``pss_sa_init_scratch_bytes``).  Replaces ``_init_round_anchored3``."""
    return _init_bytes(text, n, 'sa_init3_bytes', 3)


def _new_ctl(N: int, off: int, device) -> torch.Tensor:
    return torch.tensor([off, 0, 0, 0, N], dtype=torch.int32, device=device)


def _window_bufs(N: int, device) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """A window scan's (flags int32 [L], dest int32 [L + 1]) over the span
    of :func:`_window_span`."""
    L = _window_span(N)
    return (torch.empty(L, dtype=torch.int32, device=device),
            torch.empty(L + 1, dtype=torch.int32, device=device))


def sa_window_scan_plain(gs: torch.Tensor, ctl: torch.Tensor,
                         flags: torch.Tensor, dest: torch.Tensor, half: int,
                         W: int) -> None:
    """Plain version of B10's window scan: for the window at ``ctl[0]``,
    ``flags`` int32 [L] marks the slots off + t of the window's span (L =
    :func:`_window_span`, 0 past the row) that are tied, have their group
    start g in [off, off + W) and a member offset ``slot - g`` below
    ``half``; ``dest`` int32 [L + 1] is their exclusive scan with the count
    m_w last, and ``ctl`` gets m_w and two whole-row reductions: poisoned
    (a tied slot anywhere at a member offset of ``half`` or more) and
    whether any slot is tied."""
    N = gs.shape[0]
    off = int(ctl[_CTL_OFF])
    tied = _tied_plain(gs)
    member = torch.arange(N, device=gs.device) - gs.long()
    sel = tied & (member < half) & (gs >= off) & (gs.long() < off + W)
    span = sel[off: off + flags.shape[0]]
    flags.zero_()
    flags[: span.shape[0]] = span.to(torch.int32)
    dest.copy_(scan_exclusive_sum_plain(flags))
    ctl[_CTL_MW] = dest[-1]
    ctl[_CTL_POISONED] = int(bool((tied & (member >= half)).any()))
    ctl[_CTL_ANY_TIED] = int(bool(tied.any()))


def sa_window_scan(gs: torch.Tensor, ctl: torch.Tensor, flags: torch.Tensor,
                   dest: torch.Tensor, half: int, W: int) -> None:
    """B10's window scan on the card, in place on ``flags``, ``dest`` and
    the control block ``ctl`` int32 [5] (see
    :func:`sa_window_scan_plain`); the window's offset is read from
    ``ctl[0]`` on the device, so flags and dest cover the span from
    whatever offset the last pass left there.  The selection of
    ``_rotating_pass``."""
    if not kernels.route(gs, ctl, flags, dest):
        return sa_window_scan_plain(gs, ctl, flags, dest, half, W)
    N = gs.shape[0]
    if (half, W) != _rotating_sizes(N):
        raise ValueError('sa_window_scan: half and W must be the row\'s')
    L = _window_span(N)
    for t, name, size in ((gs, 'gs', N), (ctl, 'ctl', 5),
                          (flags, 'flags', L), (dest, 'dest', L + 1)):
        kernels.check(t, name, torch.int32, 1)
        if t.shape[0] != size:
            raise ValueError(f'sa_window_scan: {name} needs {size} entries')
    dev = gs.device
    with kernels.on(dev):
        scratch = kernels.scratch('sa_tie', L, dev)
        kernels.launch('sa_window_scan', gs.data_ptr(), N, int(half), int(W),
                       ctl.data_ptr(), flags.data_ptr(), dest.data_ptr(),
                       scratch.data_ptr())


def _window_refine_plain(sa, rank, gs, k, m, W, flags, dest, ctl) -> None:
    """Plain version of :func:`_window_refine`."""
    del m, dest  # the marks alone say which slots
    N = gs.shape[0]
    off = int(ctl[_CTL_OFF])
    refine_list_plain(sa, rank, gs, k, torch.nonzero(
        _span_mask(flags, off, N)).flatten().to(torch.int32))
    start = torch.ones(N, dtype=torch.bool, device=gs.device)
    start[1:] = gs[1:] != gs[:-1]
    starts = torch.nonzero(start & _tied_plain(gs)).flatten()
    later = starts[starts >= off + W]
    nxt = int(later[0]) if later.numel() else N
    ctl[_CTL_NEXT] = nxt
    ctl[_CTL_OFF] = nxt if nxt < N else 0


def _window_refine(sa, rank, gs, k, m, W, flags, dest, ctl) -> None:
    """The rest of a B10 pass on the card (``pss_sa_rotating_pass``): the
    m marked slots of the last window scan (its span flags and dest)
    compacted into a list and refined by B2's segmented refine by the rank
    ``k`` positions on, in place, then the jump: ``ctl[4]`` = the least slot at or past ``off + W`` that starts a
    tied group (N if none, or if off + W >= N) and ``ctl[0]`` = it, or 0
    at N."""
    if not kernels.route(sa, rank, gs, flags, dest, ctl):
        return _window_refine_plain(sa, rank, gs, k, m, W, flags, dest, ctl)
    N = gs.shape[0]
    for t, name in ((sa, 'sa'), (rank, 'rank'), (gs, 'gs')):
        kernels.check(t, name, torch.int32, 1)
        if t.shape[0] != N:
            raise ValueError('sa_rotating_pass: sa, rank and gs differ in '
                             'length')
    half, W_row = _rotating_sizes(N)
    if W != W_row or flags.shape[0] != _window_span(N):
        raise ValueError('sa_rotating_pass: W and the span flags must be '
                         'the row\'s')
    dev = gs.device
    with kernels.on(dev):
        scratch = kernels.scratch('sa_pass', m, dev)
        kernels.launch('sa_rotating_pass', sa.data_ptr(), rank.data_ptr(),
                       gs.data_ptr(), N, int(k), int(m), half, W,
                       flags.data_ptr(), dest.data_ptr(), ctl.data_ptr(),
                       scratch.data_ptr())


def _pass(scan, refine, sa, rank, gs, k, off, poisoned):
    N = gs.shape[0]
    half, W = _rotating_sizes(N)
    ctl = _new_ctl(N, off, gs.device)
    flags, dest = _window_bufs(N, gs.device)
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
    ctl = _new_ctl(N, 0, text.device)
    flags, dest = _window_bufs(N, text.device)
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
# B9: prefix doubling with dense ranks
# ---------------------------------------------------------------------------

def _dense_relabel(keys_s: torch.Tensor, idx: torch.Tensor, n: int):
    """(sa, rank, count, real) from stably sorted keys and their positions:
    dense ranks in sorted order, 0 for the smallest key; ``real`` is the
    number of distinct ranks in the last ``n`` slots (the real positions:
    pad keys are the smallest)."""
    N = keys_s.shape[0]
    change = torch.zeros(N, dtype=torch.int64, device=keys_s.device)
    change[1:] = (keys_s[1:] != keys_s[:-1]).long()
    labels = torch.cumsum(change, 0)
    rank = torch.empty_like(labels)
    rank[idx] = labels
    count = int(labels[-1]) + 1
    pads = int(labels[N - n]) if n else count
    return idx.to(torch.int32), rank.to(torch.int32), count, count - pads


def _full_counts(count: torch.Tensor):
    """(count, real) from a B9 kernel's int32 [2], read back once: the
    distinct ranks and the rank of the first real slot."""
    c, pads = count.tolist()
    return c, c - pads


def _full_init_bytes_plain(text: torch.Tensor, n: int):
    keys_s, idx = torch.sort(_byte_key(text, n), stable=True)
    return _dense_relabel(keys_s, idx, n)


def sa_full_init_bytes_plain(text: torch.Tensor, n: int):
    """Plain version of B9's init: (sa int32 [N], rank int32 [N], count):
    every position stably sorted by B1b's 6-digit key (:func:`_byte_key`),
    with dense ranks and their number."""
    return _full_init_bytes_plain(text, n)[:3]


def _full_init_bytes(text: torch.Tensor, n: int):
    N = text.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f'sa_full_init_bytes: need 0 <= n <= N, got {n}')
    if not kernels.route(text):
        return _full_init_bytes_plain(text, n)
    kernels.check(text, 'text', torch.uint8, 1)
    dev = text.device
    sa, rk, count = (torch.empty(m, dtype=torch.int32, device=dev)
                     for m in (N, N, 2))
    with kernels.on(dev):
        scratch = kernels.scratch('sa_full', N, dev)
        kernels.launch('sa_full_init_bytes', text.data_ptr(), N, int(n),
                       sa.data_ptr(), rk.data_ptr(), count.data_ptr(),
                       scratch.data_ptr())
    return (sa, rk) + _full_counts(count)


def sa_full_init_bytes(text: torch.Tensor, n: int):
    """B9's init on a uint8 [N] text row of true length ``n`` (see
    :func:`sa_full_init_bytes_plain`): the 6 digits keyed through the
    text's byte map (6 x bit_length(distinct bytes) bits), the radix sort
    and a dense relabel; the counts are read back once.  Replaces
    ``_init_round``."""
    return _full_init_bytes(text, n)[:3]


def _check_width(N: int, W: int) -> None:
    if not 0 < W <= 31 or (1 << W) <= N:
        raise ValueError(f'full round: need 2^W > N and W <= 31, got W={W}')


def _full_key_round_plain(sa: torch.Tensor, rank: torch.Tensor, k: int,
                          W: int, n: int, count: typing.Optional[int] = None):
    """Every position stably sorted by ``rank[i] << W | (rank[i + k] +
    1)``, 0 past the row, then dense ranks, in place: (count, real).
    ``count`` (the ranks' number before the round) picks the kernel's
    path and changes nothing here."""
    _check_width(rank.shape[0], W)
    r = rank.long()
    keys_s, idx = torch.sort((r << W) | _shifted(r + 1, k), stable=True)
    new_sa, new_rank, count, real = _dense_relabel(keys_s, idx, n)
    sa.copy_(new_sa)
    rank.copy_(new_rank)
    return count, real


def sa_full_round_plain(sa: torch.Tensor, rank: torch.Tensor, k: int,
                        W: int) -> int:
    """Plain version of a B9 round: every position stably sorted by
    ``rank[i] << W | (rank[i + k] + 1)``, 0 past the row, then dense ranks,
    in place; returns their number.  Every rank must be below 2^W - 1."""
    return _full_key_round_plain(sa, rank, k, W, rank.shape[0])[0]


#: A B9 round sorts every slot instead of refining the groups while fewer
#: than N / FULL_SORT_DIV ranks are distinct (see the B9 section of
#: ``csrc/suffix_array_kernels.cu``).
FULL_SORT_DIV = 8


def _full_round(sa: torch.Tensor, rank: torch.Tensor, k: int, W: int,
                n: int, count: typing.Optional[int] = None):
    N = rank.shape[0]
    _check_width(N, W)
    if not kernels.route(sa, rank):
        return _full_key_round_plain(sa, rank, k, W, n)
    kernels.check(sa, 'sa', torch.int32, 1)
    kernels.check(rank, 'rank', torch.int32, 1)
    if sa.shape[0] != N:
        raise ValueError('sa_full_round: sa and rank differ in length')
    dev = rank.device
    sort = count is not None and count * FULL_SORT_DIV < N
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    with kernels.on(dev):
        scratch = kernels.scratch('sa_full', N, dev)
        kernels.launch('sa_full_round', sa.data_ptr(), rank.data_ptr(), N,
                       int(k), W, N - int(n), int(sort), counts.data_ptr(),
                       scratch.data_ptr())
    return _full_counts(counts)


def sa_full_round(sa: torch.Tensor, rank: torch.Tensor, k: int,
                  W: int) -> int:
    """One B9 round on int32 [N] (sa, rank) in place (see
    :func:`sa_full_round_plain`), for dense ranks and ``sa`` their order
    with ties in position order, as every init and round leaves them.  It
    never sorts the rank bits again: each group, a run of slots, is
    ordered by ``rank[i + k]`` with B2's segmented refine, then every slot
    is relabelled; the count is read back once.  (The doubling loop passes
    the last count, and sorts every slot while fewer than N /
    ``FULL_SORT_DIV`` ranks are distinct.)  Replaces ``_doubling_round``."""
    return _full_round(sa, rank, k, W, rank.shape[0])[0]


def _int_width(rank: torch.Tensor) -> int:
    # Raw ranks reach 2^30, so W = 31 at most.
    return max(_key_width(rank.shape[0]), (int(rank.max()) + 1).bit_length())


def sa_full_init_int_plain(ranks: torch.Tensor, n: int):
    """Plain version of B9's integer init, the JAX first round of
    ``_int_doubling_kernel``: (sa, rank, count, real) of int32 [N]
    ``ranks`` (value + 1 in the first ``n`` slots, 0 after, at most 2^30)
    sorted by ``rank[i] << W | (rank[i + 1] + 1)``; ``real`` is the
    number of distinct ranks in the last ``n`` slots."""
    rank = ranks.to(torch.int32).clone()
    sa = torch.empty_like(rank)
    count, real = _full_key_round_plain(sa, rank, 1, _int_width(rank), n)
    return sa, rank, count, real


def sa_full_init_int(ranks: torch.Tensor, n: int):
    """B9's integer init (see :func:`sa_full_init_int_plain`): a key
    kernel, the radix sort on 2W bits and a dense relabel, the counts read
    back once."""
    N = ranks.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f'sa_full_init_int: need 0 <= n <= N, got {n}')
    if not kernels.route(ranks):
        return sa_full_init_int_plain(ranks, n)
    kernels.check(ranks, 'ranks', torch.int32, 1)
    W = _int_width(ranks)
    _check_width(N, W)
    rank = ranks.clone()
    sa = torch.empty_like(rank)
    count = torch.empty(2, dtype=torch.int32, device=rank.device)
    with kernels.on(rank.device):
        scratch = kernels.scratch('sa_full', N, rank.device)
        kernels.launch('sa_full_init_ranks', sa.data_ptr(), rank.data_ptr(),
                       N, N - int(n), W, count.data_ptr(), scratch.data_ptr())
    return (sa, rank) + _full_counts(count)


def _full_rounds(round_fn, sa, rank, count, real, k, n):
    """Double k while k < N and the last ``n`` slots (the real positions)
    hold fewer than n distinct ranks, then write the pad slots in closed
    form, [N - 1, ..., n]: the layout the JAX ``_doubling_kernel`` states.
    Pad keys sort below every real key, so once the real slots are
    distinct no later round moves one, and the JAX loop's later rounds
    (``num_ranks < N`` never holds while two pads tie) only order pads.
    Returns sa."""
    N = rank.shape[0]
    W = _key_width(N)
    while k < N and real < n:
        count, real = round_fn(sa, rank, k, W, n, count)
        k *= 2
    sa[:N - n] = torch.arange(N - 1, n - 1, -1, dtype=torch.int32,
                              device=sa.device)
    return sa


def sa_full_doubling(text: torch.Tensor, n: int) -> torch.Tensor:
    """B9, the SA of a padded uint8 [N] text row of true length ``n`` by
    prefix doubling with dense ranks, as the JAX ``_doubling_kernel``
    returns it: int32 [N] with the pad positions first, [N - 1, ..., n],
    and the text's SA in the last n slots.  The 6-byte init, then rounds
    from k = 6 until the real slots are distinct."""
    sa, rank, count, real = _full_init_bytes(text, n)
    return _full_rounds(_full_round, sa, rank, count, real, BYTE_INIT_WIDTH,
                        n)


def sa_full_doubling_plain(text: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`sa_full_doubling` through the plain versions on any device."""
    sa, rank, count, real = _full_init_bytes_plain(text, n)
    return _full_rounds(_full_key_round_plain, sa, rank, count, real,
                        BYTE_INIT_WIDTH, n)


def derive_sa_full(text: torch.Tensor, n: int,
                   out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX ``derive_sa_full_jit``: B9 (:func:`sa_full_doubling`) rolled
    to the front, into ``out`` when given.  It re-derives a row that
    :func:`segmented_rotating_sa` flags as poisoned."""
    return sa_roll_front(sa_full_doubling(text, n), n, out)


def sa_full_doubling_int(ranks: torch.Tensor, n: int) -> torch.Tensor:
    """B9's integer form, the JAX ``_int_doubling_kernel``: the SA of int32
    [N] order-preserving ranks (value + 1 in the first ``n`` slots, pad 0
    after, at most 2^30), pad positions first, [N - 1, ..., n]; the init
    at k = 1, then rounds from k = 2 until the real slots are distinct."""
    sa, rank, count, real = sa_full_init_int(ranks, n)
    return _full_rounds(_full_round, sa, rank, count, real, 2, n)


def sa_full_doubling_int_plain(ranks: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`sa_full_doubling_int` through the plain versions."""
    sa, rank, count, real = sa_full_init_int_plain(ranks, n)
    return _full_rounds(_full_key_round_plain, sa, rank, count, real, 2, n)


def suffix_array_device(data_padded: torch.Tensor, n) -> torch.Tensor:
    """The JAX ``suffix_array_device``: B9 (:func:`sa_full_doubling`) from
    device to device on ``data_padded``'s own device, with no host copy:
    int32 [N], pad-first, the SA of ``data_padded[:n]`` in ``out[N - n:]``.
    The port writes the pad slots as [N - 1, ..., n]; the JAX kernel sorts
    unstably and orders them otherwise, so only ``out[N - n:]`` compares
    with it."""
    return sa_full_doubling(data_padded, int(n))


# ---------------------------------------------------------------------------
# B14g: the per-shard steps of one row's B9 split over a mesh
# ---------------------------------------------------------------------------
#
# ``parallel/sharded.py:make_giant_chunk_build`` runs B9 on a row whose
# positions are split in S blocks of B = N / S, one a shard, as a sample
# sort a round.  These kernels are its steps that no kernel above does;
# a shard's local sort is :func:`radix_sort_pairs` and the rank store
# :func:`scatter`.  A round keys, sorts and relabels only the unsettled
# positions, whose group has two members or more: a rank block holds a
# settled position's final slot and an unsettled one's group start with
# the int32 sign bit set (``GIANT_UNSETTLED``).

#: Shards a distributed build may span (the partition's shared counts).
GIANT_MAX_SHARDS = 256

#: The mark of an unsettled position's group start (the int32 sign bit;
#: group starts are below N < 2^31).
GIANT_UNSETTLED = -(1 << 31)
_INT_MAX = (1 << 31) - 1


def giant_byte_keys_plain(text: torch.Tensor, halo: torch.Tensor, p0: int,
                          n: int):
    """Plain version of (a) at the init: (keys int64 [m], positions int32
    [m]) of the block ``text`` uint8 [m] holding positions [p0, p0 + m) of
    a row of true length ``n``, ``halo`` the (at most 5) bytes after it:
    B9's 6-byte key (:func:`_byte_key`) of every position."""
    m = text.shape[0]
    ext = torch.zeros(m + BYTE_INIT_WIDTH - 1, dtype=torch.uint8,
                      device=text.device)
    ext[:m] = text
    ext[m: m + halo.shape[0]] = halo
    keys = _byte_key(ext, min(max(n - p0, 0), ext.shape[0]))[:m]
    return keys, torch.arange(p0, p0 + m, dtype=torch.int32,
                              device=text.device)


def giant_byte_keys(text: torch.Tensor, halo: torch.Tensor, p0: int,
                    n: int):
    """(a) at the init, B14g's 6-byte keys of one shard's block (see
    :func:`giant_byte_keys_plain`)."""
    if not kernels.route(text, halo):
        return giant_byte_keys_plain(text, halo, p0, n)
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(halo, 'halo', torch.uint8, 1)
    m = text.shape[0]
    keys = torch.empty(m, dtype=torch.int64, device=text.device)
    vals = torch.empty(m, dtype=torch.int32, device=text.device)
    with kernels.on(text.device):
        kernels.launch('giant_byte_keys', text.data_ptr(), m, halo.data_ptr(),
                       halo.shape[0], int(p0), int(n), keys.data_ptr(),
                       vals.data_ptr())
    return keys, vals


def giant_round_keys_plain(rank: torch.Tensor, r2: torch.Tensor, W: int,
                           p0: int):
    """Plain version of (a) in a round: (keys int64 [u], positions int32
    [u], count int32 [1]) of the block's u unsettled positions (``rank[i]
    < 0``) in position order, with ``g << W | (r2[i] + 1)``, g and r2[i]
    their marks cleared, 0 in place of ``r2[i] + 1`` for i at or past
    ``r2``'s length (positions past the row)."""
    m = rank.shape[0]
    low = torch.zeros(m, dtype=torch.int64, device=rank.device)
    low[: r2.shape[0]] = (r2.long() & _INT_MAX) + 1
    live = rank < 0
    keys = ((rank.long() & _INT_MAX) << W) | low
    pos = torch.arange(p0, p0 + m, dtype=torch.int32, device=rank.device)
    return (keys[live], pos[live],
            live.sum().to(torch.int32).reshape(1))


def giant_round_keys(rank: torch.Tensor, r2: torch.Tensor, W: int, p0: int,
                     live: int):
    """(a) in a round, B14g's doubling keys of one shard's unsettled
    positions from its rank block ``rank`` int32 [m] and the fetched
    ``rank[i + k]`` int32 [c <= m], compacted in position order so that
    the local sort stays stable by position (see
    :func:`giant_round_keys_plain`).  ``live`` is the count the host
    expects (the send-home's); the outputs hold that many pairs, the count
    int32 [1] is the device's own, and the plain version raises where they
    differ.  On the card one pass of decoupled look-back over tiles of
    4096 positions."""
    if not kernels.route(rank, r2):
        keys, vals, count = giant_round_keys_plain(rank, r2, W, p0)
        if keys.shape[0] != live:
            raise ValueError(f'giant_round_keys: {keys.shape[0]} unsettled '
                             f'positions, the host expected {live}')
        return keys, vals, count
    kernels.check(rank, 'rank', torch.int32, 1)
    kernels.check(r2, 'r2', torch.int32, 1)
    m, c = rank.shape[0], r2.shape[0]
    if c > m or not 0 <= live <= m:
        raise ValueError('giant_round_keys: more shifted ranks than ranks, '
                         f'or {live} unsettled of {m}')
    keys = torch.empty(live, dtype=torch.int64, device=rank.device)
    vals = torch.empty(live, dtype=torch.int32, device=rank.device)
    count = torch.empty(1, dtype=torch.int32, device=rank.device)
    with kernels.on(rank.device):
        scratch = kernels.scratch('giant_keys', m, rank.device)
        kernels.launch('giant_round_keys', rank.data_ptr(), r2.data_ptr(), m,
                       c, int(W), int(p0), int(live), keys.data_ptr(),
                       vals.data_ptr(), count.data_ptr(), scratch.data_ptr())
    return keys, vals, count


def giant_cuts_plain(keys: torch.Tensor, vals: torch.Tensor,
                     skeys: torch.Tensor, spos: torch.Tensor) -> torch.Tensor:
    """Plain version of (b)'s cuts: int64 [s], the number of pairs of
    (``keys``, ``vals``) below each splitter (``skeys[j]``, ``spos[j]``) in
    (key, value) order."""
    k, sk = keys[None, :], skeys[:, None]
    below = (k < sk) | ((k == sk) & (vals[None, :].long()
                                     < spos[:, None].long()))
    return below.sum(1)


def giant_cuts(keys: torch.Tensor, vals: torch.Tensor, skeys: torch.Tensor,
               spos: torch.Tensor,
               out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b) by splitters: where the (key, position) splitters (``skeys``
    int64, ``spos`` int32 [s]) cut int64 ``keys`` with int32 ``vals``
    sorted by (key, value), one block a splitter in a 256-ary search of
    :func:`giant_cuts_rounds` dependent rounds (see
    :func:`giant_cuts_plain`); the pieces of a sorted shard are
    contiguous, so nothing moves.  Into int64 ``out`` [s] when given, so
    that the cuts of several shards come back in one copy."""
    if out is None:
        out = torch.empty(skeys.shape[0], dtype=torch.int64,
                          device=keys.device)
    if not kernels.route(keys, vals, skeys, spos, out):
        out.copy_(giant_cuts_plain(keys, vals, skeys, spos))
        return out
    kernels.check(keys, 'keys', torch.int64, 1)
    kernels.check(vals, 'vals', torch.int32, 1)
    kernels.check(skeys, 'skeys', torch.int64, 1)
    kernels.check(spos, 'spos', torch.int32, 1)
    kernels.check(out, 'out', torch.int64, 1)
    if (vals.shape[0] != keys.shape[0] or spos.shape[0] != skeys.shape[0]
            or out.shape[0] != skeys.shape[0]):
        raise ValueError('giant_cuts: keys and vals, or the splitters\' '
                         'keys, positions and cuts, differ in length')
    with kernels.on(keys.device):
        kernels.launch('giant_cuts', keys.data_ptr(), vals.data_ptr(),
                       keys.shape[0], skeys.data_ptr(), spos.data_ptr(),
                       skeys.shape[0], out.data_ptr())
    return out


#: Pairs :func:`giant_cuts`'s kernel tests in one round of its search.
GIANT_CUT_FAN = 256


def giant_cuts_rounds(m: int) -> int:
    """Dependent rounds of loads :func:`giant_cuts`'s kernel takes at most
    on ``m`` sorted pairs: each leaves fewer than ceil(len /
    ``GIANT_CUT_FAN``) pairs open, the last tests every pair left (4 at m
    = 2^27, where a binary search takes 27)."""
    rounds = 0
    while m > 0:
        m = -(-m // GIANT_CUT_FAN) - 1
        rounds += 1
    return rounds


def giant_partition_plain(pos: torch.Tensor, gs: torch.Tensor, B: int,
                          S: int):
    """Plain version of (b) by owner: the pairs (``pos[i] - d * B``,
    ``gs[i]``) of owner d = ``pos[i] // B`` in a stable order by owner, the
    count of every owner, int32 [S], and the count of every owner's
    unsettled pairs (``gs[i] < 0``), int32 [S]."""
    d = torch.div(pos.long(), B, rounding_mode='floor')
    order = torch.sort(d, stable=True).indices
    return ((pos.long() - d * B)[order].to(torch.int32),
            gs[order].to(torch.int32),
            torch.bincount(d, minlength=S).to(torch.int32),
            torch.bincount(d[gs < 0], minlength=S).to(torch.int32))


def giant_partition(pos: torch.Tensor, gs: torch.Tensor, B: int, S: int,
                    totals: typing.Optional[torch.Tensor] = None,
                    live: typing.Optional[torch.Tensor] = None):
    """(b) by owner: int32 [m] positions and group starts partitioned
    stably by the shard that owns each position, positions made local to
    its block; returns (positions, group starts, counts int32 [S]) (see
    :func:`giant_partition_plain`), the counts into int32 ``totals`` [S]
    when given, and each owner's count of unsettled pairs into int32
    ``live`` [S] when given (the card counts them only then), so that
    several shards' counts come back in one copy.  The caller's contract,
    as :func:`scatter`'s: every position lies in [0, S * B); the card does
    not check it."""
    if not 1 <= S <= GIANT_MAX_SHARDS:
        raise ValueError(f'giant_partition: 1 <= S <= {GIANT_MAX_SHARDS}, '
                         f'got {S}')
    if B < 1:
        raise ValueError(f'giant_partition: B >= 1, got {B}')
    if totals is None:
        totals = torch.empty(S, dtype=torch.int32, device=pos.device)
    extra = () if live is None else (live,)
    if not kernels.route(pos, gs, totals, *extra):
        p, g, tot, unsettled = giant_partition_plain(pos, gs, B, S)
        totals.copy_(tot)
        if live is not None:
            live.copy_(unsettled)
        return p, g, totals
    kernels.check(pos, 'pos', torch.int32, 1)
    kernels.check(gs, 'gs', torch.int32, 1)
    kernels.check(totals, 'totals', torch.int32, 1)
    if live is not None:
        kernels.check(live, 'live', torch.int32, 1)
    m = pos.shape[0]
    if gs.shape[0] != m or totals.shape[0] != S or (
            live is not None and live.shape[0] != S):
        raise ValueError('giant_partition: pos and gs differ in length, or '
                         'totals or live is not [S]')
    out_pos, out_gs = torch.empty_like(pos), torch.empty_like(gs)
    with kernels.on(pos.device):
        scratch = kernels.scratch('giant_part', (m, S), pos.device)
        kernels.launch('giant_partition', pos.data_ptr(), gs.data_ptr(), m,
                       int(B), int(S), out_pos.data_ptr(), out_gs.data_ptr(),
                       totals.data_ptr(),
                       None if live is None else live.data_ptr(),
                       scratch.data_ptr())
    return out_pos, out_gs, totals


def _relabel_flags(keys: torch.Tensor, off: int, pred, succ, shift: int):
    """(a candidates, b candidates, starts, next starts) of a shard's
    sorted keys, int64 and bool [m], for :func:`giant_flags_plain` and
    :func:`giant_relabel_plain`."""
    m = keys.shape[0]
    dev = keys.device
    first = torch.zeros(m, dtype=torch.bool, device=dev)
    prev = torch.empty_like(keys)
    if m:
        prev[1:] = keys[:-1]
        prev[0] = 0 if pred is None else pred
        first[0] = pred is None
    starts = first | (keys != prev)
    old = first | ((keys >> shift) != (prev >> shift))
    nxt = torch.ones(m, dtype=torch.bool, device=dev)
    if m:
        nxt[:-1] = starts[1:]
        nxt[-1] = succ is None or succ != int(keys[-1])
    J = off + torch.arange(m, dtype=torch.int64, device=dev)
    a = torch.where(old, (keys >> shift) - J, -1)
    b = torch.where(starts, J, -1)
    return a, b, starts, nxt


def giant_flags_plain(keys: torch.Tensor, off: int, pred, succ, shift: int,
                      real_lo: int) -> torch.Tensor:
    """Plain version of (c)'s flags: int32 [3] of a shard's sorted keys at
    list indices [off, off + m), ``pred`` the last key of the nearest
    non-empty earlier shard and ``succ`` the first of the nearest later
    one (None: no such shard): the largest a candidate (``g - J`` at the
    first member of an old group, g = ``key >> shift``), the largest b
    candidate (``J`` at the first member of a new group), -1 for none, and
    how many pairs with a key at or above ``real_lo`` (real positions) are
    unsettled (their own or their successor's key starts no group)."""
    a, b, starts, nxt = _relabel_flags(keys, off, pred, succ, shift)
    m = keys.shape[0]
    tied = int((~(starts & nxt) & (keys >= real_lo)).sum())
    return torch.tensor([int(a.max()) if m else -1,
                         int(b.max()) if m else -1, tied],
                        dtype=torch.int32, device=keys.device)


def giant_flags(keys: torch.Tensor, off: int, pred, succ, shift: int,
                real_lo: int) -> torch.Tensor:
    """(c) by flags: int32 [3] (see :func:`giant_flags_plain`), read back
    with every shard's before :func:`giant_relabel`: the first two are the
    carries out of this shard, the third its part of B9's settled stop."""
    if not kernels.route(keys):
        return giant_flags_plain(keys, off, pred, succ, shift, real_lo)
    kernels.check(keys, 'keys', torch.int64, 1)
    stats = torch.empty(3, dtype=torch.int32, device=keys.device)
    with kernels.on(keys.device):
        kernels.launch('giant_flags', keys.data_ptr(), keys.shape[0],
                       int(off), 0 if pred is None else int(pred),
                       int(pred is not None), 0 if succ is None else int(succ),
                       int(succ is not None), int(shift), int(real_lo),
                       stats.data_ptr())
    return stats


def giant_relabel_plain(keys: torch.Tensor, off: int, pred, succ,
                        shift: int, carry_a: int,
                        carry_b: int) -> torch.Tensor:
    """Plain version of (c)'s relabel in slot space: int32 [m], every
    pair's new group start ``max(cummax(b), carry_b) + max(cummax(a),
    carry_a)`` (the slot of its group's first member: the pair at list
    index J sits at slot J + g - f, f the list index of its old group's
    first member), with the sign bit (``GIANT_UNSETTLED``) set where the
    pair is unsettled; the arguments as :func:`giant_flags_plain`'s, the
    carries the largest a and b of the earlier shards (-1 for none)."""
    a, b, starts, nxt = _relabel_flags(keys, off, pred, succ, shift)
    if not keys.shape[0]:
        return torch.empty(0, dtype=torch.int32, device=keys.device)
    gs = (torch.cummax(b, 0).values.clamp(min=carry_b)
          + torch.cummax(a, 0).values.clamp(min=carry_a))
    return torch.where(starts & nxt, gs,
                       gs | GIANT_UNSETTLED).to(torch.int32)


def giant_relabel(keys: torch.Tensor, off: int, pred, succ, shift: int,
                  carry_a: int, carry_b: int) -> torch.Tensor:
    """(c) by relabel: every pair's new group start, marked where it is
    unsettled (see :func:`giant_relabel_plain`).  On the card one pass of
    decoupled look-back over tiles of 4096 pairs carrying both max scans in
    one status word: 20 bytes a pair with :func:`giant_flags`.  The
    caller's contract, which the build's lists keep: an old group starts
    at or past its first member's list index (g >= f) and below 2^31 - 1;
    the card does not check it."""
    if not kernels.route(keys):
        return giant_relabel_plain(keys, off, pred, succ, shift, carry_a,
                                   carry_b)
    kernels.check(keys, 'keys', torch.int64, 1)
    m = keys.shape[0]
    out = torch.empty(m, dtype=torch.int32, device=keys.device)
    with kernels.on(keys.device):
        scratch = kernels.scratch('giant_relabel', m, keys.device)
        kernels.launch('giant_relabel', keys.data_ptr(), m, int(off),
                       0 if pred is None else int(pred), int(pred is not None),
                       0 if succ is None else int(succ), int(succ is not None),
                       int(shift), int(carry_a), int(carry_b), out.data_ptr(),
                       scratch.data_ptr())
    return out


#: Runs one round of :func:`giant_merge`'s kernels merges into one
#: (``kMergeWays``: pairs), and the most pairs one of its segments holds
#: (``kMergeTile``; a group of w runs samples every
#: ``GIANT_MERGE_TILE // w`` pairs of each), as
#: ``csrc/suffix_array_kernels.cu`` fixes them; the tests probe the edges.
GIANT_MERGE_WAYS = 2
GIANT_MERGE_TILE = 2048


def _merge_runs(keys: torch.Tensor, vals: torch.Tensor, runs) -> list:
    runs = [int(r) for r in runs]
    m = keys.shape[0]
    if vals.shape[0] != m:
        raise ValueError('giant_merge: keys and vals differ in length')
    if any(r < 0 for r in runs) or sum(runs) != m:
        raise ValueError(f'giant_merge: run lengths {runs[:8]}... must be '
                         f'non-negative and sum to m = {m}')
    if len(runs) > GIANT_MAX_SHARDS:
        raise ValueError(f'giant_merge: at most {GIANT_MAX_SHARDS} runs, '
                         f'got {len(runs)}')
    return runs


def giant_merge_rounds(runs) -> int:
    """Rounds :func:`giant_merge`'s kernels take on runs of these lengths:
    the non-empty runs merged ``GIANT_MERGE_WAYS`` at a time until one is
    left (0 for at most one, then ceil(log2) of their number: 2 at 4, 8 at
    256)."""
    left = sum(1 for r in runs if r)
    rounds = 0
    while left > 1:
        left = -(-left // GIANT_MERGE_WAYS)
        rounds += 1
    return rounds


def giant_merge_plain(keys: torch.Tensor, vals: torch.Tensor, runs):
    """Plain version of the merge: (keys, vals) of the concatenated runs of
    lengths ``runs`` in (key, run, index) order, a stable sort by key of
    the concatenation, as :func:`radix_sort_pairs` sorts it.  Raises when
    the run lengths do not sum to m."""
    _merge_runs(keys, vals, runs)
    keys_s, order = torch.sort(keys, stable=True)
    return keys_s, vals[order]


def giant_merge(keys: torch.Tensor, vals: torch.Tensor, runs):
    """Step 4 of the giant build: int64 ``keys`` with int32 ``vals`` [m]
    hold S <= ``GIANT_MAX_SHARDS`` runs of the host lengths ``runs``
    (summing to m), each sorted by (key, value); returns the pairs in (key,
    run, index) order (see :func:`giant_merge_plain`), which is the
    shard's (key, position) order when the runs come in position order.
    The caller's contract: the runs are sorted; the card does not check
    it.  On the card rounds of pairwise merges (``GIANT_MERGE_WAYS``
    runs into one), 24 bytes a pair a round, behind one counted launch;
    the result comes in new tensors after an odd number of rounds
    (:func:`giant_merge_rounds`) and in ``keys`` / ``vals`` otherwise, new
    tensors of the same size then serving as the rounds' other buffer, so
    the caller gives the inputs up and takes the returned pair."""
    runs = _merge_runs(keys, vals, runs)
    if not kernels.route(keys, vals):
        return giant_merge_plain(keys, vals, runs)
    kernels.check(keys, 'keys', torch.int64, 1)
    kernels.check(vals, 'vals', torch.int32, 1)
    m = keys.shape[0]
    rounds = giant_merge_rounds(runs)
    if rounds:
        out_k, out_v = torch.empty_like(keys), torch.empty_like(vals)
    else:
        out_k, out_v = keys, vals
    lengths = np.asarray(runs, dtype=np.int64)
    with kernels.on(keys.device):
        scratch = kernels.scratch('giant_merge', (m, len(runs)), keys.device)
        kernels.launch('giant_merge', keys.data_ptr(), vals.data_ptr(), m,
                       lengths.ctypes.data, len(runs), out_k.data_ptr(),
                       out_v.data_ptr(), scratch.data_ptr())
    return (out_k, out_v) if rounds % 2 else (keys, vals)
