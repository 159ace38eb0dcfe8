"""Batched substring probe over suffix arrays, and the index's aux builders.

Semantics match a byte-wise bisection of the SA:

- ``lower`` = first SA slot whose suffix is >= the pattern, where a suffix
  that starts with the pattern compares equal;
- ``count`` = number of suffixes that start with the pattern (``upper -
  lower``, ``upper`` being the first slot whose suffix is greater and does
  not start with it).

The device index stores, per row, a seed table and packed limb planes:

- the seed table maps the first ``depth`` bytes of a pattern, as alphabet
  rank digits in base ``base``, to the SA range of suffixes that start with
  them;
- limb plane j holds, for every SA slot, the next few bytes of the suffix
  after the seed depth packed into one int32: ``30 // bits`` rank digits
  for a ranked alphabet (at most 62 distinct bytes), or 4 raw bytes with
  the top one biased by -128 for a large NUL-free alphabet.
- the digit kind (a large alphabet with NUL) keys on base-258 digits
  (byte + 1, 0 past the end): a bucket table over the first 2 or 3 digits,
  and limb j holding digits ``2 + 3j .. 4 + 3j`` whatever the depth.

A probe seeds its range from the table, bisects through the limbs, and
compares raw bytes for patterns longer than the packed coverage.

The device functions that carry the index are CUDA kernels
(``csrc/search_kernels.cu``), each with a plain PyTorch version beside it:

- :func:`ranked_pack`   (K1): next rank digits of every text position;
- :func:`ranked_limb_planes` (K2): all ranked limb planes in SA order,
  gathered from the text (the JAX program gathers K1's pack);
- :func:`seed_table`    (K3): the seed table from the ranked pack, and
  :func:`seed_table_from_prefix` the same kernel on K7's prefix values;
- :func:`raw_pack`      (K5): next 4 raw bytes of every text position,
  the JAX ``raw_pack_jit``'s counterpart (no path of the port needs it);
- :func:`raw_limb_planes` (K6): all raw limb planes in SA order, from the
  text;
- :func:`seed_prefix`   (K7): the seed depth's rank digits of every text
  position, for any rank map and base;
- :func:`digit_bucket_table` and :func:`digit_limb_planes` (B12d): the
  digit kind's table from K7's base-258 values with K3, and its limbs by
  the limb-plane kernel at offset 2, stride 3;
- :func:`probe_phased`  (K4): the phased probe;
- :func:`probe_limbs`   (B11): the digit kind's probe;
- :func:`gather_hits_flat` (B8): a merged row's hits as flat (position,
  query) pairs;
- :func:`probe_bytes` (B15): the byte-window bisection over bare (text,
  SA) rows, also as :func:`probe_bounds` / :func:`probe_bounds_loop`, with
  :func:`build_bucket_table` (K7 and K3 again) and the capped gather
  :func:`gather_hit_positions`.

Each wrapper takes its plain version only for a tensor on the CPU.  On a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from . import kernels
from .suffix_array import _shifted, scan_exclusive_sum

#: Digit space for byte ranks in the full-byte seed table: byte b -> b + 1,
#: past-the-end -> 0, and 257 as the +infinity digit.
_RADIX = 258

#: (base, depth) combinations a seed table may use.  Ranked bases are
#: powers of two, so every table length identifies its parameters.
_TABLE_COMBOS = tuple(
    (base, d)
    for base in (32, 64, 128, _RADIX)
    for d in (2, 3, 4, 5)
    if base ** d <= 1 << 28
)

#: Zero-byte margin every device text row carries after position n, so
#: suffix reads up to this many bytes never leave the row.  Longer patterns
#: are answered on the host.
PAD_MARGIN = 1024

#: Limb planes of the raw and ranked encodings (the most the index keeps).
RAW_LIMBS = 3

#: K4's split (``kPhasedPairsWide`` in ``csrc/search_kernels.cu``): a batch
#: of more (row, pattern) pairs than this launches
#: ``probe_phased_wide_kernel``, a thread a pair; up to it,
#: ``probe_phased_kernel``, 4 lanes a pair.
PHASED_PAIRS_WIDE = 1 << 16

#: Limb planes of the digit kind at most: each holds 3 base-258 digits, so
#: the bucket's 2 digits and KEY_LIMBS limbs cover ``2 + 3 * KEY_LIMBS``
#: bytes of every suffix.
KEY_LIMBS = 5

#: Digit-kind bucket tables: one entry per 2- or 3-digit prefix value plus
#: a terminator.
BUCKET_TABLE_SIZE = _RADIX * _RADIX + 1
BUCKET_TABLE_SIZE_3 = _RADIX * _RADIX * _RADIX + 1

#: The digit kind's limbs start at byte 2 whatever the bucket depth.
DIGIT_LIMB_OFFSET = 2
DIGIT_LIMB_STRIDE = 3


def key_cover_bytes(num_limbs: int = KEY_LIMBS) -> int:
    return DIGIT_LIMB_OFFSET + DIGIT_LIMB_STRIDE * num_limbs


def bucket_depth(table_len: int) -> int:
    """Prefix depth of a digit-kind bucket table from its length."""
    if table_len == BUCKET_TABLE_SIZE:
        return 2
    if table_len == BUCKET_TABLE_SIZE_3:
        return 3
    raise ValueError(f'not a bucket table length: {table_len}')


def table_params(table_len: int):
    """(base, depth) encoded by a seed table's length."""
    for base, d in _TABLE_COMBOS:
        if base ** d + 1 == table_len:
            return base, d
    raise ValueError(f'not a seed table length: {table_len}')


def pick_table_params(sigma: int, max_n: int):
    """The seed table's (base, depth) for an alphabet of ``sigma`` distinct
    bytes and rows of at most ``max_n`` chars.

    Base: the smallest power of two holding every rank plus the two pad
    digits (0 = past-end, base-1 = +inf); full-byte alphabets take base
    258.  Depth: as deep as both a hard entry cap and the row size allow.
    """
    base = next((b for b in (32, 64, 128) if sigma + 2 <= b), _RADIX)
    cap = min(48 << 20, max(base ** 2, max_n))
    depth = max(d for b, d in _TABLE_COMBOS if b == base and b ** d <= cap)
    return base, depth


def pack_patterns(patterns, max_len: typing.Optional[int] = None):
    """Pack byte-string patterns into (uint8[B, L], int32[B]) host arrays.

    ``L`` is rounded up to 8, 11, 14 or 17, then to multiples of 8, as the
    JAX package does, so both packages see the same batch arrays.  An
    explicit ``max_len`` is used literally.
    """
    lengths = np.array([len(p) for p in patterns], dtype=np.int32)
    if max_len is None:
        L = int(lengths.max(initial=0))
        if L <= 17:
            L = next(w for w in (8, 11, 14, 17) if w >= max(8, L))
        else:
            L = -(-L // 8) * 8
    else:
        L = max_len
    packed = np.zeros((len(patterns), L), dtype=np.uint8)
    for i, p in enumerate(patterns):
        packed[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    return packed, lengths


def alphabet_rank(present: np.ndarray):
    """(rank[256] int32, sigma) for a boolean present-bytes mask.

    ``rank[b] = 1 + #present bytes < b``: the rank of b when present, its
    insertion rank when absent.  Digit 0 is the past-end pad.
    """
    present = np.asarray(present, dtype=bool)
    rank = np.zeros(256, dtype=np.int32)
    rank[1:] = np.cumsum(present.astype(np.int32))[:-1]
    return rank + 1, int(present.sum())


def identity_rank():
    """rank/present pair for the full-byte (base 258) digit table."""
    return (
        np.arange(1, 257, dtype=np.int32),
        np.ones(256, dtype=np.int32),
    )


def ranked_bits(sigma: int) -> typing.Optional[int]:
    """Bits per rank digit for the ranked limb encoding, or None when the
    alphabet is too large for it to beat raw byte packing."""
    if sigma <= 30:
        return 5
    if sigma <= 62:
        return 6
    return None


def ranked_limb_bytes(bits: int) -> int:
    return 30 // bits


def ranked_cover_bytes(num_limbs: int, depth: int, bits: int) -> int:
    return depth + ranked_limb_bytes(bits) * num_limbs


def raw_cover_bytes(num_limbs: int = RAW_LIMBS, depth: int = 3) -> int:
    return depth + 4 * num_limbs


# ---------------------------------------------------------------------------
# Host builders (numpy)
# ---------------------------------------------------------------------------

def build_seed_table_host(
    data: np.ndarray, sa: np.ndarray, rank: np.ndarray, base: int, depth: int
) -> np.ndarray:
    """Seed table: table[k] = first SA slot whose depth-digit rank prefix
    is >= k, or n."""
    size = base ** depth + 1
    n = data.size
    if n == 0:
        return np.zeros(size, dtype=np.int32)
    rk = rank.astype(np.int64)[data]
    b = np.zeros(n, dtype=np.int64)
    sa64 = sa.astype(np.int64)
    for j in range(depth):
        nxt = sa64 + j
        dj = np.where(nxt < n, rk[np.minimum(nxt, n - 1)], 0)
        b = b * base + dj
    probes = np.arange(size, dtype=np.int64)
    return np.searchsorted(b, probes, side='left').astype(np.int32)


def build_ranked_limbs_host(
    data: np.ndarray, sa: np.ndarray, rank: np.ndarray,
    num_limbs: int, depth: int, bits: int,
) -> np.ndarray:
    """[num_limbs, n] int32 rank-packed limbs, plane-major: limb j of slot
    i packs the rank digits of bytes ``sa[i]+depth+D*j .. +D-1`` (D = 30 //
    bits) big-endian; past-the-end digits are 0."""
    n = data.size
    D = ranked_limb_bytes(bits)
    if n == 0:
        return np.zeros((num_limbs, 0), dtype=np.int32)
    width = depth + D * num_limbs
    dig = np.zeros(n + width, dtype=np.int64)
    dig[:n] = rank.astype(np.int64)[data]
    out = np.empty((num_limbs, n), dtype=np.int32)
    base_off = sa.astype(np.int64) + depth
    for j in range(num_limbs):
        o = base_off + D * j
        v = np.zeros(n, dtype=np.int64)
        for i in range(D):
            v = (v << bits) + dig[o + i]
        out[j] = v.astype(np.int32)
    return out


def build_raw_limbs_host(
    data: np.ndarray, sa: np.ndarray, num_limbs: int = RAW_LIMBS,
    depth: int = 3,
) -> np.ndarray:
    """[num_limbs, n] int32 raw-packed limbs, plane-major: limb j of slot i
    is bytes ``sa[i]+depth+4j .. +3`` big-endian with the top byte biased by
    -128, zero past the end.  Exact only for NUL-free text."""
    n = data.size
    if n == 0:
        return np.zeros((num_limbs, 0), dtype=np.int32)
    width = raw_cover_bytes(num_limbs, depth)
    b = np.zeros(n + width, dtype=np.int64)
    b[:n] = data
    out = np.empty((num_limbs, n), dtype=np.int32)
    base = sa.astype(np.int64) + depth
    for j in range(num_limbs):
        o = base + 4 * j
        v = (
            (b[o] - 128) * 16777216
            + b[o + 1] * 65536
            + b[o + 2] * 256
            + b[o + 3]
        )
        out[j] = v.astype(np.int32)
    return out


def pad_limbs_host(limbs: np.ndarray, n_pad: int) -> np.ndarray:
    """Place plane-major limbs ``[num_limbs, n]`` into the flat padded
    device layout ``[num_limbs * n_pad]`` (plane j at ``j * n_pad``)."""
    num_limbs, n = limbs.shape
    out = np.zeros(num_limbs * n_pad, dtype=np.int32)
    for j in range(num_limbs):
        out[j * n_pad: j * n_pad + n] = limbs[j]
    return out


def build_limbs_host(data: np.ndarray, sa: np.ndarray,
                     num_limbs: int = KEY_LIMBS) -> np.ndarray:
    """[num_limbs, n] int32 digit-kind limbs, plane-major: limb j of slot i
    packs bytes ``sa[i]+2+3j .. +2`` as three base-258 digits (byte + 1, 0
    past the end)."""
    n = data.size
    if n == 0:
        return np.zeros((num_limbs, 0), dtype=np.int32)
    digits = np.zeros(n + key_cover_bytes(num_limbs), dtype=np.int32)
    digits[:n] = data.astype(np.int32) + 1
    out = np.empty((num_limbs, n), dtype=np.int32)
    base = sa.astype(np.int64) + DIGIT_LIMB_OFFSET
    for j in range(num_limbs):
        o = base + DIGIT_LIMB_STRIDE * j
        out[j] = (digits[o] * _RADIX + digits[o + 1]) * _RADIX + digits[o + 2]
    return out


def build_bucket_table_host(data: np.ndarray, sa: np.ndarray,
                            depth: int = 2) -> np.ndarray:
    """Digit-kind bucket table: table[k] = first SA slot whose ``depth``
    base-258 digit prefix value is >= k, or n."""
    size = _RADIX ** depth + 1
    n = data.size
    if n == 0:
        return np.zeros(size, dtype=np.int32)
    b = np.zeros(n, dtype=np.int64)
    for j in range(depth):
        nxt = sa.astype(np.int64) + j
        dj = np.where(
            nxt < n, data[np.minimum(nxt, n - 1)].astype(np.int64) + 1, 0
        )
        b = b * _RADIX + dj  # non-decreasing over SA order
    probes = np.arange(size, dtype=np.int64)
    return np.searchsorted(b, probes, side='left').astype(np.int32)


def host_probe_bounds(data: bytes, sa: np.ndarray, pattern: bytes):
    """(lower, count) for one pattern by scalar bisection on the host."""
    n = sa.shape[0]
    L = len(pattern)

    def cmp_at(slot: int) -> int:
        start = int(sa[slot])
        s = data[start: start + L]
        if s == pattern:
            return 0
        return -1 if s < pattern else 1

    def first_geq(threshold: int) -> int:
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if cmp_at(mid) >= threshold:
                hi = mid
            else:
                lo = mid + 1
        return lo

    lower = first_geq(0)
    upper = first_geq(1)
    return lower, upper - lower


# ---------------------------------------------------------------------------
# Device functions: kernel wrappers and their plain PyTorch versions
# ---------------------------------------------------------------------------

def ranked_pack_plain(text: torch.Tensor, n: int, rank: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """Plain version of K1: int32 [N], position p's next ``30 // bits``
    rank digits packed big-endian; digits at or past n are 0."""
    N = text.shape[0]
    iota = torch.arange(N, device=text.device)
    e = torch.where(iota < n, rank.long()[text.long()], 0)
    v = torch.zeros_like(e)
    for d in range(ranked_limb_bytes(bits)):
        v = (v << bits) + _shifted(e, d)
    return v.to(torch.int32)


def ranked_pack(text: torch.Tensor, n: int, rank: torch.Tensor, bits: int,
                out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1, ranked pack: int32 [N] for a uint8 [N] text row of true length
    ``n`` (see :func:`ranked_pack_plain`)."""
    N = text.shape[0]
    if out is None:
        out = torch.empty(N, dtype=torch.int32, device=text.device)
    if not kernels.route(text, rank, out):
        out.copy_(ranked_pack_plain(text, n, rank, bits))
        return out
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(rank, 'rank', torch.int32, 1)
    kernels.check(out, 'out', torch.int32, 1)
    if out.shape[0] != N or rank.shape[0] != 256 or bits not in (5, 6):
        raise ValueError('ranked_pack: bad shapes or bits')
    with kernels.on(text.device):
        kernels.launch('ranked_pack', text.data_ptr(), N, int(n),
                       rank.data_ptr(), bits, out.data_ptr())
    return out


def _limb_planes_plain(packed: torch.Tensor, sa: torch.Tensor, n: int,
                       depth: int, stride: int,
                       num_limbs: int) -> torch.Tensor:
    """int32 [num_limbs * N], plane-major: ``limbs[j*N + i] =
    packed[min(sa[i] + depth + stride*j, N - 1)]`` for i < n, else 0."""
    N = packed.shape[0]
    iota = torch.arange(N, device=packed.device)
    s = sa.long().clamp(0, N - 1)
    cols = []
    for j in range(num_limbs):
        idx = (s + depth + stride * j).clamp(0, N - 1)
        cols.append(torch.where(iota < n, packed[idx], 0))
    return torch.cat(cols).to(torch.int32)


def ranked_limb_planes_plain(packed: torch.Tensor, sa: torch.Tensor, n: int,
                             depth: int, bits: int,
                             num_limbs: int) -> torch.Tensor:
    """Plain version of K2: int32 [num_limbs * N], plane-major;
    ``limbs[j*N + i] = packed[sa[i] + depth + D*j]`` for i < n, else 0."""
    return _limb_planes_plain(packed, sa, n, depth, ranked_limb_bytes(bits),
                              num_limbs)


def _window_planes_plain(digits: torch.Tensor, sa: torch.Tensor, n: int,
                         off: int, D: int, num_limbs: int, scale: int,
                         bias: int, clamp: bool) -> torch.Tensor:
    """int32 [num_limbs * N], plane-major, from a text's digits (int32
    [N + pad], 0 at or past n): plane j of slot i < n folds the D digits
    from ``start = clip(sa[i]) + off + D*j`` (at most N - 1 where
    ``clamp``) as ``v * scale + digit``, plus ``bias``; 0 for i >= n.
    Positions stay int32 (N + pad < 2^31) and one plane is built at a
    time, so a row past 2^31 plane offsets fits beside the kernel's."""
    N = sa.shape[0]
    s = sa.clamp(0, N - 1)
    valid = torch.arange(N, dtype=torch.int32, device=sa.device) < n
    out = torch.empty(num_limbs * N, dtype=torch.int32, device=sa.device)
    for j in range(num_limbs):
        start = s + (off + D * j)
        if clamp:
            start = start.clamp(max=N - 1)
        v = torch.zeros(N, dtype=torch.int64, device=sa.device)
        for d in range(D):
            v = v * scale + digits[start + d]
        out[j * N:(j + 1) * N] = torch.where(valid, v + bias, 0)
    return out


def _text_digits(text: torch.Tensor, n: int, values: torch.Tensor,
                 pad: int) -> torch.Tensor:
    """int32 [N + pad]: ``values`` (a digit per text position) below n,
    else 0."""
    N = text.shape[0]
    out = torch.zeros(N + pad, dtype=torch.int32, device=text.device)
    out[:N] = torch.where(torch.arange(N, device=text.device) < n, values, 0)
    return out


def ranked_limb_planes_text_plain(text: torch.Tensor, sa: torch.Tensor,
                                  n: int, rank: torch.Tensor, depth: int,
                                  bits: int,
                                  num_limbs: int) -> torch.Tensor:
    """K2 from the text, as its kernel computes it: plane j of slot i < n
    packs the rank digits of text positions ``min(clip(sa[i]) + depth +
    D*j, N - 1) ..`` (D = 30 // bits), 0 at or past n.  Equals
    :func:`ranked_limb_planes_plain` of K1's pack."""
    D = ranked_limb_bytes(bits)
    digits = _text_digits(text, n, rank[text.long()], D)
    return _window_planes_plain(digits, sa, n, depth, D, num_limbs,
                                1 << bits, 0, True)


def ranked_limb_planes(text: torch.Tensor, sa: torch.Tensor, n: int,
                       rank: torch.Tensor, depth: int, bits: int,
                       num_limbs: int,
                       out: typing.Optional[torch.Tensor] = None,
                       ) -> torch.Tensor:
    """K2, limb planes: every plane of one row in one pass over ``sa``,
    gathered from the text with the rank map ``rank`` int32 [256] (see
    :func:`ranked_limb_planes_text_plain`; the JAX program gathers K1's
    pack, :func:`ranked_limb_planes_plain`, to the same planes)."""
    N = text.shape[0]
    if out is None:
        out = torch.empty(num_limbs * N, dtype=torch.int32,
                          device=text.device)
    if not kernels.route(text, sa, rank, out):
        out.copy_(ranked_limb_planes_text_plain(text, sa, n, rank, depth,
                                                bits, num_limbs))
        return out
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(rank, 'rank', torch.int32, 1)
    kernels.check(sa, 'sa', torch.int32, 1)
    kernels.check(out, 'out', torch.int32, 1)
    if (sa.shape[0] != N or out.shape[0] != num_limbs * N
            or rank.shape[0] != 256 or bits not in (5, 6)):
        raise ValueError('ranked_limb_planes: bad shapes or bits')
    with kernels.on(text.device):
        kernels.launch('ranked_limb_planes', text.data_ptr(),
                       rank.data_ptr(), sa.data_ptr(), N, int(n), depth,
                       bits, num_limbs, out.data_ptr())
    return out


def _table_plain(src: torch.Tensor, sa: torch.Tensor, n: int, size: int,
                 shift: int) -> torch.Tensor:
    """int32 [size], entry k = first SA slot i < n whose key ``src[sa[i]]
    >> shift`` is >= k, or n."""
    probes = torch.arange(size, dtype=torch.int64, device=src.device)
    if n == 0:
        return torch.zeros(size, dtype=torch.int32, device=src.device)
    keys = src[sa[:n].long()].long() >> shift
    return torch.searchsorted(keys, probes, side='left').to(torch.int32)


def _table(src: torch.Tensor, sa: torch.Tensor, n: int, size: int,
           shift: int, out: typing.Optional[torch.Tensor]) -> torch.Tensor:
    """K3 on any int32 [N] key source whose keys never decrease in SA
    order (see :func:`_table_plain`)."""
    if out is None:
        out = torch.empty(size, dtype=torch.int32, device=src.device)
    if not kernels.route(src, sa, out):
        out.copy_(_table_plain(src, sa, n, size, shift))
        return out
    kernels.check(src, 'packed', torch.int32, 1)
    kernels.check(sa, 'sa', torch.int32, 1)
    kernels.check(out, 'out', torch.int32, 1)
    if out.shape[0] != size:
        raise ValueError('seed_table: bad output shape')
    with kernels.on(src.device):
        scratch = kernels.scratch('seed_table', size, src.device)
        kernels.launch('seed_table', src.data_ptr(), sa.data_ptr(), int(n),
                       shift, size, scratch.data_ptr(), out.data_ptr())
    return out


def _check_ranked_table(base: int, depth: int, bits: int) -> int:
    """The key shift of a ranked table from the pack; raises unless
    ``base == 1 << bits`` and ``depth <= D``."""
    if base != 1 << bits or depth > ranked_limb_bytes(bits):
        raise ValueError('seed_table: base must be 1 << bits, depth <= D')
    return (ranked_limb_bytes(bits) - depth) * bits


def seed_table_plain(packed: torch.Tensor, sa: torch.Tensor, n: int,
                     base: int, depth: int, bits: int) -> torch.Tensor:
    """Plain version of K3: int32 [base^depth + 1], entry k = first SA slot
    whose ``depth``-digit key ``packed[sa[i]] >> ((D - depth) * bits)`` is
    >= k, or n."""
    shift = _check_ranked_table(base, depth, bits)
    return _table_plain(packed, sa, n, base ** depth + 1, shift)


def seed_table(packed: torch.Tensor, sa: torch.Tensor, n: int, base: int,
               depth: int, bits: int,
               out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3, seed table of one row from its ranked pack (see
    :func:`seed_table_plain`).  Needs ``base == 1 << bits``."""
    shift = _check_ranked_table(base, depth, bits)
    return _table(packed, sa, n, base ** depth + 1, shift, out)


def seed_table_from_prefix_plain(pv: torch.Tensor, sa: torch.Tensor, n: int,
                                 base: int, depth: int) -> torch.Tensor:
    """Plain version of K3 on K7's prefix values: int32 [base^depth + 1],
    entry k = first SA slot whose ``pv[sa[i]]`` is >= k, or n."""
    return _table_plain(pv, sa, n, base ** depth + 1, 0)


def seed_table_from_prefix(pv: torch.Tensor, sa: torch.Tensor, n: int,
                           base: int, depth: int,
                           out: typing.Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K3, seed table of one row from K7's prefix values (shift 0; see
    :func:`seed_table_from_prefix_plain`).  With :func:`seed_prefix` it
    replaces ``build_seed_table_device``: ``pv`` never decreases in SA
    order, so the bisection gives the JAX scatter-min and reverse cummin's
    table."""
    return _table(pv, sa, n, base ** depth + 1, 0, out)


def raw_pack_plain(text: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K5: int32 [N], position p's next 4 bytes
    big-endian with the top byte biased by -128; bytes at or past n are 0,
    so a position at or past n packs INT32_MIN."""
    iota = torch.arange(text.shape[0], device=text.device)
    b = torch.where(iota < n, text.long(), 0)
    v = b - 128
    for d in range(1, 4):
        v = v * 256 + _shifted(b, d)
    return v.to(torch.int32)


def raw_pack(text: torch.Tensor, n: int,
             out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5, raw pack: int32 [N] for a uint8 [N] text row of true length
    ``n`` (see :func:`raw_pack_plain`).  Replaces ``raw_pack_jit``."""
    N = text.shape[0]
    if out is None:
        out = torch.empty(N, dtype=torch.int32, device=text.device)
    if not kernels.route(text, out):
        out.copy_(raw_pack_plain(text, n))
        return out
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(out, 'out', torch.int32, 1)
    if out.shape[0] != N:
        raise ValueError('raw_pack: bad output shape')
    with kernels.on(text.device):
        kernels.launch('raw_pack', text.data_ptr(), N, int(n),
                       out.data_ptr())
    return out


def raw_limb_planes_plain(packed: torch.Tensor, sa: torch.Tensor, n: int,
                          depth: int, num_limbs: int) -> torch.Tensor:
    """Plain version of K6: int32 [num_limbs * N], plane-major;
    ``limbs[j*N + i] = packed[min(sa[i] + depth + 4j, N - 1)]`` for i < n,
    else 0."""
    return _limb_planes_plain(packed, sa, n, depth, 4, num_limbs)


def raw_limb_planes_text_plain(text: torch.Tensor, sa: torch.Tensor,
                               n: int, depth: int,
                               num_limbs: int) -> torch.Tensor:
    """K6 from the text, as its kernel computes it: plane j of slot i < n
    is the 4 bytes from ``min(clip(sa[i]) + depth + 4j, N - 1)``
    big-endian, the top one biased by -128, a byte at or past n 0.  Equals
    :func:`raw_limb_planes_plain` of K5's pack."""
    digits = _text_digits(text, n, text.int(), 4)
    return _window_planes_plain(digits, sa, n, depth, 4, num_limbs, 256,
                                -(1 << 31), True)


def raw_limb_planes(text: torch.Tensor, sa: torch.Tensor, n: int,
                    depth: int, num_limbs: int,
                    out: typing.Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """K6, raw limb planes: every plane of one row in one pass over ``sa``,
    gathered from the text (see :func:`raw_limb_planes_text_plain`; the JAX
    programs gather K5's pack, :func:`raw_limb_planes_plain`, to the same
    planes).  Replaces ``derive_limb_raw_jit`` and
    ``build_raw_limbs_device``."""
    N = text.shape[0]
    if out is None:
        out = torch.empty(num_limbs * N, dtype=torch.int32,
                          device=text.device)
    if not kernels.route(text, sa, out):
        out.copy_(raw_limb_planes_text_plain(text, sa, n, depth, num_limbs))
        return out
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(sa, 'sa', torch.int32, 1)
    kernels.check(out, 'out', torch.int32, 1)
    if sa.shape[0] != N or out.shape[0] != num_limbs * N:
        raise ValueError('raw_limb_planes: bad shapes')
    with kernels.on(text.device):
        kernels.launch('raw_limb_planes', text.data_ptr(), sa.data_ptr(),
                       N, int(n), depth, num_limbs, out.data_ptr())
    return out


def seed_prefix_plain(text: torch.Tensor, n: int, rank: torch.Tensor,
                      base: int, depth: int) -> torch.Tensor:
    """Plain version of K7: int32 [N], the ``depth`` rank digits of
    ``text[p:]`` in base ``base``; a digit at or past n is 0."""
    iota = torch.arange(text.shape[0], device=text.device)
    e = torch.where(iota < n, rank.long()[text.long()], 0)
    v = torch.zeros_like(e)
    for d in range(depth):
        v = v * base + _shifted(e, d)
    return v.to(torch.int32)


def seed_prefix(text: torch.Tensor, n: int, rank: torch.Tensor, base: int,
                depth: int,
                out: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7, seed prefix: int32 [N] prefix values of a uint8 [N] text row of
    true length ``n`` with the byte -> digit map ``rank`` int32 [256] (see
    :func:`seed_prefix_plain`).  Any base of the table combinations (258
    for a full-byte alphabet, with :func:`identity_rank` the digit kind's
    bucket digits)."""
    N = text.shape[0]
    if (base, depth) not in _TABLE_COMBOS:
        raise ValueError(f'seed_prefix: no table of {base}^{depth}')
    if out is None:
        out = torch.empty(N, dtype=torch.int32, device=text.device)
    if not kernels.route(text, rank, out):
        out.copy_(seed_prefix_plain(text, n, rank, base, depth))
        return out
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(rank, 'rank', torch.int32, 1)
    kernels.check(out, 'out', torch.int32, 1)
    if out.shape[0] != N or rank.shape[0] != 256:
        raise ValueError('seed_prefix: bad shapes')
    with kernels.on(text.device):
        kernels.launch('seed_prefix', text.data_ptr(), N, int(n),
                       rank.data_ptr(), base, depth, out.data_ptr())
    return out


def _lane_setup(patterns, lengths, rank, present, base, depth, num_limbs,
                bits):
    """Per-pattern seeding of the phased probe: (bucket_lo, bucket_up with
    the exact-depth bump, lower targets [B, K], upper targets [B, K],
    phase count k [B], absent-byte flag bad [B]), all int64/bool."""
    B, L = patterns.shape
    dev = patterns.device
    D = 4 if bits is None else ranked_limb_bytes(bits)
    width = depth + D * num_limbs
    raw = torch.zeros((B, width), dtype=torch.int64, device=dev)
    cols = min(L, width)
    raw[:, :cols] = patterns[:, :cols].long()
    lens = lengths.long()
    ipos = torch.arange(width, device=dev)[None, :]
    in_len = ipos < lens[:, None]
    r = rank.long()[raw]
    pres = present[raw] > 0

    # Seed buckets: lower lanes pad past the pattern with 0, upper with
    # base-1; an absent byte within the depth collapses both ids.
    ip, il, rd = ipos[:, :depth], in_len[:, :depth], r[:, :depth]
    first_bad = torch.where(il & ~pres[:, :depth], ip, depth).min(1).values
    at = ip == first_bad[:, None]
    past = ip > first_bad[:, None]
    dl = torch.where(past, 0, torch.where(at | il, rd, 0))
    du = torch.where(past, 0, torch.where(at | il, rd, base - 1))
    bucket_lo = torch.zeros(B, dtype=torch.int64, device=dev)
    bucket_up = torch.zeros(B, dtype=torch.int64, device=dev)
    for j in range(depth):
        bucket_lo = bucket_lo * base + dl[:, j]
        bucket_up = bucket_up * base + du[:, j]
    prefix_present = first_bad >= lens.clamp(max=depth)
    bump = (lens == depth) & prefix_present
    bucket_up = bucket_up + bump.long()

    if bits is None:
        lo_v = torch.where(in_len, raw, 0)
        up_v = torch.where(in_len, raw, 255)

        def limb(v, j):
            o = depth + 4 * j
            return ((v[:, o] - 128) * 16777216 + v[:, o + 1] * 65536
                    + v[:, o + 2] * 256 + v[:, o + 3])
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
    else:
        lo_v = torch.where(in_len, r, 0)
        up_v = torch.where(in_len, r, (1 << bits) - 1)

        def limb(v, j):
            acc = torch.zeros(B, dtype=torch.int64, device=dev)
            for i in range(D):
                acc = (acc << bits) + v[:, depth + D * j + i]
            return acc
        bad = (in_len & ~pres).any(1)
    t_lo = torch.stack([limb(lo_v, j) for j in range(num_limbs)], 1)
    t_up = torch.stack([limb(up_v, j) for j in range(num_limbs)], 1)
    k = torch.div(lens - depth + D - 1, D, rounding_mode='floor')
    k = k.clamp(0, num_limbs)
    return bucket_lo, bucket_up, t_lo, t_up, k, bad


def _first_true(lo: torch.Tensor, hi: torch.Tensor, pred) -> torch.Tensor:
    """Per lane, the first slot in [lo, hi) where the monotone ``pred``
    holds (hi when none does)."""
    while True:
        active = lo < hi
        if not bool(active.any()):
            return lo
        mid = torch.div(lo + hi, 2, rounding_mode='floor')
        p = pred(mid)
        hi = torch.where(active & p, mid, hi)
        lo = torch.where(active & ~p, mid + 1, lo)


def _deep_refine_plain(text, n, sa, patterns, lengths, cover: int,
                       A: torch.Tensor, Z: torch.Tensor) -> None:
    """Patterns longer than ``cover`` bytes: bisect each row's [A, Z) again
    with a byte compare of the whole pattern against each suffix (a text
    position at or past n reads as digit 0), in place."""
    C, N = text.shape
    dev = text.device
    deep = torch.nonzero(lengths.long() > cover).flatten()
    if not deep.numel():
        return
    plen = lengths.long()[deep]
    Lp = int(plen.max())
    pats = patterns[deep, :Lp].long()
    jpos = torch.arange(Lp, device=dev)
    jmask = jpos[None, :] < plen[:, None]
    p1 = torch.where(jmask, pats + 1, 0)[None]
    nrow = n.long()[:, None]

    def cmp3(mid):
        slot = torch.minimum(mid.clamp(min=0), (nrow - 1).clamp(min=0))
        starts = sa.gather(1, slot).long()
        pos = starts[..., None] + jpos
        byte = text.gather(1, pos.clamp(0, N - 1).reshape(C, -1))
        byte = byte.reshape(pos.shape).long()
        s = torch.where(pos < nrow[..., None], byte + 1, 0)
        d = torch.sign(s - p1) * jmask[None]
        first = (d != 0).to(torch.int32).argmax(-1, keepdim=True)
        return d.gather(-1, first).squeeze(-1)

    a0, z0 = A[:, deep], Z[:, deep]
    a = _first_true(a0, z0, lambda m: cmp3(m) >= 0)
    z = _first_true(a0, z0, lambda m: cmp3(m) >= 1)
    A[:, deep] = a
    Z[:, deep] = z


def probe_phased_plain(text, n, sa, tables, limbs, rank, present, patterns,
                       lengths, num_limbs: int, base: int, depth: int,
                       bits: typing.Optional[int]):
    """Plain version of K4: (lower, count) int32 [C, B] for a pattern batch
    against every row (see :func:`probe_phased`)."""
    C, N = text.shape
    B = patterns.shape[0]
    bucket_lo, bucket_up, t_lo, t_up, k, bad = _lane_setup(
        patterns, lengths, rank, present, base, depth, num_limbs, bits
    )

    def seed(bucket):
        return tables.gather(1, bucket[None, :].expand(C, B)).long()

    A = seed(bucket_lo)
    Z = seed(bucket_up)
    lo, hi = A, seed(bucket_lo + 1)
    act = (k >= 1)[None, :].expand(C, B)
    limbs64 = limbs.long()
    for j in range(num_limbs):
        act = act & (j < k)[None, :]
        if not bool(act.any()):
            break

        def value(mid, j=j):
            return limbs64.gather(1, j * N + mid.clamp(0, N - 1))

        hi_act = torch.where(act, hi, lo)
        a = _first_true(lo, hi_act, lambda m: value(m) >= t_lo[None, :, j])
        z = _first_true(lo, hi_act, lambda m: value(m) > t_up[None, :, j])
        A = torch.where(act, a, A)
        Z = torch.where(act, z, Z)
        act = act & (j + 1 < k)[None, :] & (a < z)
        lo = torch.where(act, a, lo)
        hi = torch.where(act, z, hi)

    D = 4 if bits is None else ranked_limb_bytes(bits)
    _deep_refine_plain(text, n, sa, patterns, lengths,
                       depth + D * num_limbs, A, Z)
    count = Z - A
    if bits is not None:
        count = torch.where(bad[None, :], 0, count)
    return A.to(torch.int32), count.to(torch.int32)


def probe_phased(text, n, sa, tables, limbs, rank, present, patterns,
                 lengths, num_limbs: int, base: int, depth: int,
                 bits: typing.Optional[int]):
    """K4, the phased probe: (lower, count) int32 [C, B].

    text uint8 [C, N], n int32 [C], sa int32 [C, N], tables int32
    [C, base^depth + 1], limbs int32 [C, num_limbs * N] plane-major,
    rank / present int32 [256], patterns uint8 [B, L] (zero padded),
    lengths int32 [B].  ``bits`` None selects the raw 4-byte limbs.
    ``lower`` is exact where count > 0; for a pattern with a byte absent
    from the alphabet it may sit at a neighbouring bucket's start.
    """
    C, N = text.shape
    B, L = patterns.shape
    if not kernels.route(text, n, sa, tables, limbs, rank, present, patterns,
                  lengths):
        return probe_phased_plain(text, n, sa, tables, limbs, rank, present,
                                  patterns, lengths, num_limbs, base, depth,
                                  bits)
    for t, name, dt, nd in (
        (text, 'text', torch.uint8, 2), (n, 'n', torch.int32, 1),
        (sa, 'sa', torch.int32, 2), (tables, 'tables', torch.int32, 2),
        (limbs, 'limbs', torch.int32, 2), (rank, 'rank', torch.int32, 1),
        (present, 'present', torch.int32, 1),
        (patterns, 'patterns', torch.uint8, 2),
        (lengths, 'lengths', torch.int32, 1),
    ):
        kernels.check(t, name, dt, nd)
    table_len = base ** depth + 1
    if (sa.shape != (C, N) or tables.shape != (C, table_len)
            or limbs.shape != (C, num_limbs * N) or n.shape[0] != C
            or lengths.shape[0] != B or not 1 <= num_limbs <= 8):
        raise ValueError('probe_phased: bad shapes')
    lower = torch.empty((C, B), dtype=torch.int32, device=text.device)
    count = torch.empty((C, B), dtype=torch.int32, device=text.device)
    if C == 0 or B == 0:
        return lower, count
    with kernels.on(text.device):
        kernels.launch(
            'probe_phased', text.data_ptr(), n.data_ptr(), sa.data_ptr(),
            tables.data_ptr(), limbs.data_ptr(), rank.data_ptr(),
            present.data_ptr(), patterns.data_ptr(), lengths.data_ptr(),
            C, B, L, N, table_len, num_limbs, depth, base, bits or 0,
            lower.data_ptr(), count.data_ptr(),
        )
    return lower, count


def _digit_stream(text: torch.Tensor, n: int, extra: int) -> torch.Tensor:
    """int64 [N + extra]: byte + 1 for positions < n, else 0."""
    N = text.shape[0]
    iota = torch.arange(N + extra, device=text.device)
    padded = torch.zeros(N + extra, dtype=torch.int64, device=text.device)
    padded[:N] = text.long()
    return torch.where(iota < n, padded + 1, 0)


def digit_limb_planes_plain(text: torch.Tensor, sa: torch.Tensor, n: int,
                            num_limbs: int) -> torch.Tensor:
    """Plain version of B12d's limbs: int32 [num_limbs * N], plane-major;
    for slot i < n, limb j packs the digits of bytes ``sa[i] + 2 + 3j ..
    +2`` in base 258 (byte + 1, 0 at or past n); 0 for i >= n."""
    digits = _text_digits(text, n, text.int() + 1,
                          key_cover_bytes(num_limbs))
    return _window_planes_plain(digits, sa, n, DIGIT_LIMB_OFFSET,
                                DIGIT_LIMB_STRIDE, num_limbs, _RADIX, 0,
                                False)


def _identity_rank_on(device) -> torch.Tensor:
    return torch.as_tensor(identity_rank()[0], device=device)


def digit_limb_planes(text: torch.Tensor, sa: torch.Tensor, n: int,
                      num_limbs: int,
                      out: typing.Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """B12d's limbs of one row, gathered from the text (see
    :func:`digit_limb_planes_plain`) by the limb-plane kernel at offset 2,
    stride 3, base 258.  Replaces ``build_limbs_device``."""
    N = text.shape[0]
    if out is None:
        out = torch.empty(num_limbs * N, dtype=torch.int32,
                          device=text.device)
    if not kernels.route(text, sa, out):
        out.copy_(digit_limb_planes_plain(text, sa, n, num_limbs))
        return out
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(sa, 'sa', torch.int32, 1)
    kernels.check(out, 'out', torch.int32, 1)
    if sa.shape[0] != N or out.shape[0] != num_limbs * N:
        raise ValueError('digit_limb_planes: bad shapes')
    with kernels.on(text.device):
        kernels.launch('digit_limb_planes', text.data_ptr(), sa.data_ptr(),
                       N, int(n), num_limbs, out.data_ptr())
    return out


def digit_bucket_table_plain(text: torch.Tensor, sa: torch.Tensor, n: int,
                             depth: int) -> torch.Tensor:
    """Plain version of B12d's table: int32 [258^depth + 1], entry k = first
    SA slot i < n whose suffix's ``depth``-digit base-258 prefix is >= k,
    or n."""
    size = _RADIX ** depth + 1
    if n == 0:
        return torch.zeros(size, dtype=torch.int32, device=text.device)
    d = _digit_stream(text, n, depth)
    s = sa[:n].long()
    key = torch.zeros(n, dtype=torch.int64, device=text.device)
    for j in range(depth):
        key = key * _RADIX + d[s + j]
    probes = torch.arange(size, dtype=torch.int64, device=text.device)
    return torch.searchsorted(key, probes, side='left').to(torch.int32)


def digit_bucket_table(text: torch.Tensor, sa: torch.Tensor, n: int,
                       depth: int,
                       out: typing.Optional[torch.Tensor] = None,
                       scratch: typing.Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """B12d's bucket table of one row (see
    :func:`digit_bucket_table_plain`): K7 with ``identity_rank()`` at base
    258 and this depth into ``scratch``, then K3 on its values.  Replaces
    ``build_bucket_table_device``."""
    if depth not in (2, 3):
        raise ValueError(f'digit bucket depth is 2 or 3, got {depth}')
    if not kernels.route(text, sa):
        table = digit_bucket_table_plain(text, sa, n, depth)
        return table if out is None else out.copy_(table)
    pv = seed_prefix(text, n, _identity_rank_on(text.device), _RADIX, depth,
                     out=scratch)
    return seed_table_from_prefix(pv, sa, n, _RADIX, depth, out=out)


def probe_limbs_plain(text, n, sa, tables, limbs, patterns, lengths,
                      num_limbs: int):
    """Plain version of B11: (lower, count) int32 [C, B] for a pattern batch
    against every row of a digit-kind index (see :func:`probe_limbs`)."""
    C, N = text.shape
    B, L = patterns.shape
    dev = text.device
    depth = bucket_depth(tables.shape[1])
    width = max(key_cover_bytes(num_limbs), depth)
    raw = torch.zeros((B, width), dtype=torch.int64, device=dev)
    cols = min(L, width)
    raw[:, :cols] = patterns[:, :cols].long() + 1
    lens = lengths.long()
    in_len = torch.arange(width, device=dev)[None, :] < lens[:, None]
    # ceil((len - 2) / 3) limbs, at least 1 and at most num_limbs.
    k = torch.div(lens, DIGIT_LIMB_STRIDE, rounding_mode='floor')
    k = k.clamp(1, num_limbs)
    jj = torch.arange(num_limbs, device=dev)
    used = (jj[None, :] < k[:, None])[None]  # [1, B, K]
    limbs64 = limbs.long()

    def first_key(pad: int, threshold: int):
        dig = torch.where(in_len, raw, pad)
        bucket = torch.zeros(B, dtype=torch.int64, device=dev)
        for q in range(depth):
            bucket = bucket * _RADIX + dig[:, q]
        t = torch.stack([
            (dig[:, o] * _RADIX + dig[:, o + 1]) * _RADIX + dig[:, o + 2]
            for o in (DIGIT_LIMB_OFFSET + DIGIT_LIMB_STRIDE * j
                      for j in range(num_limbs))
        ], 1)[None]  # [1, B, K]

        def pred(mid):
            idx = jj * N + mid.clamp(0, N - 1)[..., None]  # [C, B, K]
            v = limbs64.gather(1, idx.reshape(C, -1)).reshape(C, B, -1)
            d = torch.sign(v - t) * used
            first = (d != 0).to(torch.int32).argmax(-1, keepdim=True)
            return d.gather(-1, first).squeeze(-1) >= threshold

        lo = tables.gather(1, bucket[None, :].expand(C, B)).long()
        hi = tables.gather(1, (bucket + 1)[None, :].expand(C, B)).long()
        return _first_true(lo, hi, pred)

    A = first_key(0, 0)
    Z = first_key(_RADIX - 1, 1)
    _deep_refine_plain(text, n, sa, patterns, lengths,
                       key_cover_bytes(num_limbs), A, Z)
    return A.to(torch.int32), (Z - A).to(torch.int32)


def probe_limbs(text, n, sa, tables, limbs, patterns, lengths,
                num_limbs: int):
    """B11, the digit-kind probe: (lower, count) int32 [C, B].

    text uint8 [C, N], n int32 [C], sa int32 [C, N], tables int32
    [C, 258^d + 1] (d 2 or 3, read from the length), limbs int32
    [C, num_limbs * N] plane-major (B12d), patterns uint8 [B, L] (zero
    padded), lengths int32 [B].  Each pattern's lower and upper bound
    bisect the limbs inside their bucket (the lower padded past the pattern
    with digit 0, the upper with 257); a pattern longer than
    ``key_cover_bytes(num_limbs)`` then bisects the text.  Replaces
    ``probe_bounds_limbs_loop`` / ``limbs_loop_batch_jit``: ``lower`` and
    ``count`` equal the JAX program's everywhere."""
    C, N = text.shape
    B, L = patterns.shape
    if not kernels.route(text, n, sa, tables, limbs, patterns, lengths):
        return probe_limbs_plain(text, n, sa, tables, limbs, patterns,
                                 lengths, num_limbs)
    for t, name, dt in (
        (text, 'text', torch.uint8), (sa, 'sa', torch.int32),
        (tables, 'tables', torch.int32), (limbs, 'limbs', torch.int32),
        (patterns, 'patterns', torch.uint8),
    ):
        kernels.check(t, name, dt, 2)
    kernels.check(n, 'n', torch.int32, 1)
    kernels.check(lengths, 'lengths', torch.int32, 1)
    table_len = tables.shape[1]
    depth = bucket_depth(table_len)
    if (sa.shape != (C, N) or tables.shape[0] != C
            or limbs.shape != (C, num_limbs * N) or n.shape[0] != C
            or lengths.shape[0] != B or not 1 <= num_limbs <= 8):
        raise ValueError('probe_limbs: bad shapes')
    lower = torch.empty((C, B), dtype=torch.int32, device=text.device)
    count = torch.empty((C, B), dtype=torch.int32, device=text.device)
    if C == 0 or B == 0:
        return lower, count
    with kernels.on(text.device):
        kernels.launch(
            'probe_limbs', text.data_ptr(), n.data_ptr(), sa.data_ptr(),
            tables.data_ptr(), limbs.data_ptr(), patterns.data_ptr(),
            lengths.data_ptr(), C, B, L, N, table_len, depth, num_limbs,
            lower.data_ptr(), count.data_ptr(),
        )
    return lower, count


def gather_hits_flat_plain(sa_row: torch.Tensor, lower: torch.Tensor,
                           count: torch.Tensor):
    """Plain version of B8: (pos, qid) int32 [sum(count)], query q's SA
    range ``sa_row[lower[q] : lower[q] + count[q]]`` at the exclusive
    prefix sum of the counts, with q beside every position."""
    dev = sa_row.device
    count = count.long()
    T = int(count.sum())
    qid = torch.repeat_interleave(
        torch.arange(count.shape[0], device=dev), count
    )
    starts = torch.cumsum(count, 0) - count
    slot = lower.long()[qid] + torch.arange(T, device=dev) - starts[qid]
    return sa_row[slot].to(torch.int32), qid.to(torch.int32)


def gather_hits_flat(sa_row: torch.Tensor, lower: torch.Tensor,
                     count: torch.Tensor):
    """B8, flat hit gather: (pos, qid) int32 tensors of exactly
    ``sum(count)`` entries for one row's int32 [N] SA and a batch's int32
    [B] bounds (see :func:`gather_hits_flat_plain`).  The offsets are the
    scan kernel's exclusive sum of ``count``; reading their total is the
    one host synchronisation, and sizes the kernel's grid of output tiles.
    The total must stay below 2^31."""
    if not kernels.route(sa_row, lower, count):
        return gather_hits_flat_plain(sa_row, lower, count)
    kernels.check(sa_row, 'sa_row', torch.int32, 1)
    kernels.check(lower, 'lower', torch.int32, 1)
    kernels.check(count, 'count', torch.int32, 1)
    B = lower.shape[0]
    if count.shape[0] != B:
        raise ValueError('gather_hits_flat: lower and count differ in length')
    dev = sa_row.device
    if B == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    offsets = scan_exclusive_sum(count)
    total = int(offsets[B])
    if total < 0:
        raise ValueError('gather_hits_flat: the hit total overflows int32')
    pos = torch.empty(total, dtype=torch.int32, device=dev)
    qid = torch.empty(total, dtype=torch.int32, device=dev)
    with kernels.on(dev):
        kernels.launch('gather_hits_flat', sa_row.data_ptr(),
                       lower.data_ptr(), offsets.data_ptr(), B, total,
                       pos.data_ptr(), qid.data_ptr())
    return pos, qid


# ---------------------------------------------------------------------------
# B15: the byte-window probe, bucket table and capped gather over bare
# (text, SA) rows, as the chunk-parallel programs (parallel/sharded.py) use
# them
# ---------------------------------------------------------------------------

def _cmp3_rows(text, n, sa, slots, p1, jmask):
    """The JAX ``_cmp3`` for lanes [M] against rows [C]: int64 [C, M], -1
    where the suffix at SA slot ``slots[r, m]`` (clipped to [0, n - 1]) is
    below pattern m, 0 where it starts with it, +1 above.  ``p1`` int64
    [M, L] is the pattern bytes + 1, 0 outside ``jmask``."""
    C, N = text.shape
    M, L = p1.shape
    c = torch.minimum(slots.clamp(min=0), (n - 1).clamp(min=0)[:, None])
    starts = sa.gather(1, c).long()
    pos = starts[..., None] + torch.arange(L, device=text.device)
    byte = text.gather(1, pos.clamp(0, N - 1).reshape(C, -1))
    s = torch.where(pos < n[:, None, None], byte.reshape(C, M, L).long() + 1,
                    0)
    d = torch.sign(s - p1[None]) * jmask[None]
    first = (d != 0).to(torch.int32).argmax(-1, keepdim=True)
    return d.gather(-1, first).squeeze(-1)


def probe_bytes_plain(text, n, sa, patterns, lengths):
    """Plain version of B15: (lower, count) int32 [C, B], the JAX duplex
    (``_duplex`` and ``_bisect_first_geq`` over ``_cmp3``), all [C, 2B]
    lanes of a block of rows at once: lanes [0, B) bisect [0, n) for the
    first slot comparing >= 0, lanes [B, 2B) for the first comparing >= 1;
    count is their difference."""
    C, N = text.shape
    B, L = patterns.shape
    dev = text.device
    if L == 0:  # every pattern is empty; one zero column compares alike
        patterns = torch.zeros((B, 1), dtype=torch.uint8, device=dev)
        L = 1
    jmask = (torch.arange(L, device=dev)[None, :]
             < lengths.long().clamp(0, L)[:, None])
    p1 = torch.where(jmask, patterns.long() + 1, 0)
    p1, jmask = torch.cat([p1, p1]), torch.cat([jmask, jmask])
    thresholds = torch.cat([torch.zeros(B, dtype=torch.int64, device=dev),
                            torch.ones(B, dtype=torch.int64, device=dev)])
    nrow = n.long()
    lower = torch.empty((C, B), dtype=torch.int32, device=dev)
    count = torch.empty((C, B), dtype=torch.int32, device=dev)
    step = max(1, (1 << 24) // max(1, 2 * B * L))  # rows per block
    for r0 in range(0, C, step):
        t, s, nn = text[r0: r0 + step], sa[r0: r0 + step], nrow[r0: r0 + step]
        lo = torch.zeros((t.shape[0], 2 * B), dtype=torch.int64, device=dev)
        hi = nn[:, None].expand(-1, 2 * B).clone()
        bounds = _first_true(
            lo, hi, lambda m: _cmp3_rows(t, nn, s, m, p1, jmask) >= thresholds)
        lower[r0: r0 + step] = bounds[:, :B]
        count[r0: r0 + step] = bounds[:, B:] - bounds[:, :B]
    return lower, count


def probe_bytes(text, n, sa, patterns, lengths):
    """B15, the byte-window bisection probe: (lower, count) int32 [C, B]
    for uint8 [C, N] rows of true lengths n int32 [C] with head-aligned SA
    int32 [C, N] (real entries in [0, n)), and a batch of uint8 [B, L]
    zero-padded patterns of int32 [B] lengths, in one launch.  The empty
    pattern counts n, an empty row 0, and no row is read past its own n.
    This is the vmapped form of the JAX ``probe_bounds_loop``; see
    :func:`probe_bytes_plain` for the semantics."""
    C, N = text.shape
    B, L = patterns.shape
    if not kernels.route(text, n, sa, patterns, lengths):
        return probe_bytes_plain(text, n, sa, patterns, lengths)
    for t, name, dt, nd in (
        (text, 'text', torch.uint8, 2), (n, 'n', torch.int32, 1),
        (sa, 'sa', torch.int32, 2), (patterns, 'patterns', torch.uint8, 2),
        (lengths, 'lengths', torch.int32, 1),
    ):
        kernels.check(t, name, dt, nd)
    if sa.shape != (C, N) or n.shape[0] != C or lengths.shape[0] != B:
        raise ValueError('probe_bytes: bad shapes')
    lower = torch.empty((C, B), dtype=torch.int32, device=text.device)
    count = torch.empty((C, B), dtype=torch.int32, device=text.device)
    if C == 0 or B == 0:
        return lower, count
    with kernels.on(text.device):
        kernels.launch('probe_bytes', text.data_ptr(), n.data_ptr(),
                       sa.data_ptr(), patterns.data_ptr(),
                       lengths.data_ptr(), C, B, L, N, lower.data_ptr(),
                       count.data_ptr())
    return lower, count


def probe_bounds(text, n, sa, patterns, lengths):
    """(lower, count) int32 [B] of a pattern batch against one row: the
    JAX single-row signature (text uint8 [N], n, sa int32 [N]), B15 with
    C = 1 (:func:`probe_bytes`)."""
    nt = torch.as_tensor([int(n)], dtype=torch.int32, device=text.device)
    lower, count = probe_bytes(text[None], nt, sa[None], patterns, lengths)
    return lower[0], count[0]


#: The JAX loop form computes the same bounds as the unrolled one; B15
#: serves both names.
probe_bounds_loop = probe_bounds


def build_bucket_table(text: torch.Tensor, n: int, sa: torch.Tensor,
                       depth: int = 2) -> torch.Tensor:
    """B15's bucket table, the JAX ``build_bucket_table``: int32
    [258^depth + 1], entry k the first SA slot whose ``depth``-digit
    base-258 prefix (byte + 1, 0 at or past n) is >= k, or n, for a padded
    uint8 [N] row and its padded SA [N].  The same function as the digit
    kind's :func:`digit_bucket_table` (K7 with ``identity_rank()``, then
    K3), so no kernel of its own.  The row must carry ``depth - 1`` bytes
    of margin past n, as the index's rows do: without it the JAX version
    clips its windows and reads other bytes."""
    n = int(n)
    if n > 0 and n + depth - 1 > text.shape[0]:
        raise ValueError('build_bucket_table: the row needs depth - 1 bytes '
                         'of margin past n')
    return digit_bucket_table(text, sa, n, depth)


def gather_hit_positions_plain(sa: torch.Tensor, lower: torch.Tensor,
                               count: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain version of B15's capped gather: int32 [B, min(cap, N)], entry
    (b, off) the text position at SA slot ``lower[b] + off`` (clipped to
    [0, N - 1]) for off < count[b], else -1."""
    N = sa.shape[0]
    off = torch.arange(min(cap, N), device=sa.device)[None, :]
    slot = (lower.long()[:, None] + off).clamp(0, max(N - 1, 0))
    return torch.where(off < count.long()[:, None], torch.take(sa, slot),
                       -1).to(torch.int32)


def gather_hit_positions(sa: torch.Tensor, lower: torch.Tensor,
                         count: torch.Tensor, cap: int) -> torch.Tensor:
    """B15, the capped hit gather: text positions of up to ``cap`` hits per
    query from one row's int32 [N] SA and a batch's int32 [B] bounds, -1
    padded, int32 [B, min(cap, N)] (see :func:`gather_hit_positions_plain`).
    Replaces ``gather_hit_positions`` / ``_gather_hits_jit``."""
    if not kernels.route(sa, lower, count):
        return gather_hit_positions_plain(sa, lower, count, cap)
    kernels.check(sa, 'sa', torch.int32, 1)
    kernels.check(lower, 'lower', torch.int32, 1)
    kernels.check(count, 'count', torch.int32, 1)
    N, B = sa.shape[0], lower.shape[0]
    if count.shape[0] != B:
        raise ValueError('gather_hit_positions: lower and count differ')
    c = min(int(cap), N)
    out = sa.new_empty((B, max(c, 0)))  # int32 on sa's device, no parsing
    if B == 0 or c <= 0:
        return out
    with kernels.on(sa.device):
        kernels.launch('gather_hit_positions', sa.data_ptr(),
                       lower.data_ptr(), count.data_ptr(), B, N, c,
                       out.data_ptr())
    return out
