"""The yardstick of the kernels: the card's published peaks and the bytes a
probe needs at the least.

A roofline share is the least time the card could take for the work,
over the time the kernel took.  The least time counts what these inputs
need, whatever the kernel reads again, so that no implementation can
read above 100%.
"""

from __future__ import annotations

import typing

import numpy as np

#: Published peaks (NVIDIA's data sheet, SXM part, dense): bytes/s of HBM
#: and FLOP/s, at the full 700 W power limit.
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'hbm_bytes_per_s': 3.35e12,
                              'bf16_flops': 989e12, 'fp32_flops': 67e12},
}
#: A DRAM sector: the least the card moves for one scattered read.
SECTOR_BYTES = 32


def peak(device_name: str, key: str) -> typing.Optional[float]:
    """The published peak ``key`` of the card named ``device_name``, or
    None for a card the table lacks (its share is then not reported)."""
    return PEAKS.get(device_name, {}).get(key)


def probe_bytes(lengths: np.ndarray) -> int:
    """Bytes a probe of patterns of ``lengths`` needs at the least: each
    pattern byte read once, its bounds (two int32) written once, and for
    each of its two bounds one sector of the suffix array and the sectors
    of text that hold the pattern's length (the least that confirms a
    match at a bound, with any index)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    text_sectors = -(-lengths // SECTOR_BYTES)
    return int((lengths + 8 + 2 * SECTOR_BYTES * (1 + text_sectors)).sum())
