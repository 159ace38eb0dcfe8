"""On-disk index container — byte-compatible with the reference format.

The reference (Intsights/PySubstringSearch) serializes each flushed chunk as

    u32 LE  len(text)          | text bytes (entries joined by b"\\n", trailing b"\\n")
    u32 LE  4 * len(sa)        | suffix array as int32 LE values

appended back to back until EOF (reference: src/lib.rs:105-124 for the writer,
src/lib.rs:161-199 for the reader loop).  A file produced by this module is
readable by the reference Reader and vice versa.

This is pure host-side IO (numpy); no device code lives here.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import typing

import numpy as np

_U32 = struct.Struct('<I')

#: Default chunk capacity, identical to the reference (src/lib.rs:57).
DEFAULT_MAX_CHUNK_LEN = 512 * 1024 * 1024


@dataclasses.dataclass
class Chunk:
    """One self-contained (text, suffix array) record of the container."""

    #: Concatenated entry bytes, each entry terminated by b"\n".
    data: np.ndarray  # uint8 [n]
    #: Suffix array over ``data``: int32 [n], sorted byte-wise with the
    #: shorter-suffix-first (prefix-is-less) convention.
    suffix_array: np.ndarray  # int32 [n]
    #: Byte offset of ``data`` within its container file (-1 when the chunk
    #: does not come from a mapped container).  Lets extraction address all
    #: chunks of one file through a single flat buffer (global coordinates).
    text_offset: int = -1

    def __post_init__(self) -> None:
        assert self.data.dtype == np.uint8
        assert self.suffix_array.dtype == np.int32
        assert self.data.shape == self.suffix_array.shape


def write_chunk(
    fobj: typing.BinaryIO,
    data: np.ndarray,
    suffix_array: np.ndarray,
) -> None:
    """Append one framed (text, SA) record (reference: src/lib.rs:105-124)."""
    if data.size == 0:
        return
    if data.size > 0xFFFFFFFF or suffix_array.size * 4 > 0xFFFFFFFF:
        raise ValueError('chunk too large for u32 container framing')
    fobj.write(_U32.pack(data.size))
    fobj.write(memoryview(data))  # buffer protocol: no tobytes() copy
    fobj.write(_U32.pack(suffix_array.size * 4))
    sa_le = suffix_array.astype('<i4', copy=False)
    fobj.write(memoryview(sa_le if sa_le.flags.c_contiguous else
                          np.ascontiguousarray(sa_le)))


@dataclasses.dataclass
class MappedContainer:
    """A parsed container whose chunk arrays are views into one mmap.

    The reference Reader loads chunk text into RAM and *seeks past the SA
    without reading it* (src/lib.rs:179-182) — host RAM ~= corpus size.  The
    mapped load goes further: NOTHING is read eagerly (only the 8-byte
    headers are touched during the parse), text and SA pages fault in on
    first use and stay evictable, so a 7.5 GB index opens in milliseconds
    and steady-state residency is only what queries actually touch.
    """

    path: str
    #: uint8 view over the whole file (zero-length for an empty container).
    buf: np.ndarray
    chunks: typing.List[Chunk]


def read_container(index_file_path: str) -> MappedContainer:
    """Parse the container headers and return mmap-backed chunks.

    Greedy until EOF like the reference loop (src/lib.rs:174-196).  Each
    chunk's ``data`` / ``suffix_array`` is a zero-copy view into the file
    mapping (the SA view is generally 4-byte *unaligned* — fine for numpy
    gathers and the native kernels' scalar loads on every supported host).

    Raises ``FileNotFoundError`` for a missing path (parity with the Rust
    ``File::open`` error surfaced through PyO3) and ``ValueError`` for a
    truncated / malformed container (the reference panics; we return a typed
    error per SURVEY.md §5.3).
    """
    file_len = os.path.getsize(index_file_path)
    if file_len == 0:
        return MappedContainer(
            path=index_file_path, buf=np.zeros(0, dtype=np.uint8), chunks=[]
        )
    mm = np.memmap(index_file_path, dtype=np.uint8, mode='r')
    chunks: typing.List[Chunk] = []
    off = 0
    while off < file_len:
        if off + 4 > file_len:
            raise ValueError('truncated index container: bad text header')
        (data_len,) = _U32.unpack(mm[off: off + 4])
        off += 4
        if off + data_len > file_len:
            raise ValueError('truncated index container: short text chunk')
        text_offset = off
        data = mm[off: off + data_len]
        off += data_len
        if off + 4 > file_len:
            raise ValueError('truncated index container: bad SA header')
        (sa_bytes,) = _U32.unpack(mm[off: off + 4])
        off += 4
        if sa_bytes % 4 != 0:
            raise ValueError(
                'malformed index container: SA length not a multiple of 4'
            )
        if off + sa_bytes > file_len:
            raise ValueError('truncated index container: short suffix array')
        sa = mm[off: off + sa_bytes].view('<i4')
        off += sa_bytes
        chunks.append(
            Chunk(data=data, suffix_array=sa, text_offset=text_offset)
        )
    return MappedContainer(path=index_file_path, buf=mm, chunks=chunks)


def read_chunks(index_file_path: str) -> typing.List[Chunk]:
    """Chunk list of :func:`read_container` (compatibility surface; the
    arrays are lazy mmap views — see MappedContainer)."""
    return read_container(index_file_path).chunks


#: Rust RawVec's smallest non-zero capacity for 1-byte elements; part of the
#: amortized-growth rule emulated below.
_VEC_MIN_NON_ZERO_CAP = 8


class ChunkBuffer:
    """Entry-accumulation buffer with the reference Writer's flush policy.

    Mirrors the observable behavior of the Rust Writer's ``Vec<u8>`` buffer
    (src/lib.rs:88-103): an entry that would overflow the capacity triggers
    a flush first; a single line longer than the capacity (only possible
    through the file-lines path, src/lib.rs:67-86) still becomes its own
    oversized chunk.

    Capacity-growth quirk parity: in the reference the flush threshold is
    the live ``Vec::capacity()``, and an oversized line *permanently grows*
    it — ``extend_from_slice``/``push`` reserve via Rust's amortized rule
    ``new_cap = max(2 * cap, required, 8)`` and ``buffer.clear()`` in
    ``dump_data`` (src/lib.rs:121) never shrinks.  Every later flush (and
    ``add_entry``'s "entry is too big" guard, src/lib.rs:92-94) compares
    against the grown capacity, so chunk boundaries for the rest of that
    Writer's life shift.  ``append`` emulates the two reserve steps (entry
    bytes, then the ``\\n`` push) so container bytes match the reference
    even after oversized lines.
    """

    def __init__(self, max_chunk_len: typing.Optional[int] = None) -> None:
        self.capacity = (
            DEFAULT_MAX_CHUNK_LEN if max_chunk_len is None else max_chunk_len
        )
        self._parts: typing.List[bytes] = []
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def would_overflow(self, entry_len: int) -> bool:
        return self._size + entry_len + 1 > self.capacity

    def _reserve(self, required: int) -> None:
        if required > self.capacity:
            self.capacity = max(
                2 * self.capacity, required, _VEC_MIN_NON_ZERO_CAP
            )

    def append(self, entry: bytes) -> None:
        self._reserve(self._size + len(entry))
        self._parts.append(entry)
        self._size += len(entry)
        self._reserve(self._size + 1)
        self._parts.append(b'\n')
        self._size += 1

    def append_block(self, block: bytes) -> None:
        """Bulk append of already-``\\n``-terminated whole lines known to fit
        the live capacity (the Writer's fast ingest path).  No reserve
        emulation is needed: Rust's ``Vec`` growth rule only fires when the
        required size exceeds the capacity, which the caller has excluded.
        """
        assert self._size + len(block) <= self.capacity
        self._parts.append(block)
        self._size += len(block)

    def take(self) -> np.ndarray:
        """Return the buffered bytes as uint8 and reset the buffer."""
        joined = b''.join(self._parts)
        self._parts = []
        self._size = 0
        return np.frombuffer(joined, dtype=np.uint8)
