"""The card's published peak and the bytes each measured kernel needs.

Every roofline share of the benchmark is the least time the bytes could take
at the published HBM bandwidth, over the time measured. The byte counts are
what the algorithm must move whatever implements it: each input byte read
once and each output byte written once.
"""
from __future__ import annotations

#: NVIDIA H100 SXM (80 GB HBM3) device memory bandwidth, NVIDIA's data
#: sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float) -> float:
    """The least seconds `nbytes` take at the published bandwidth."""
    return nbytes / HBM_BYTES_PER_S


def ragged_launch_bytes(codes: int, rows: int, windows: int) -> int:
    """One launch of the extraction kernel's ragged entry: int8 codes read
    once, a row table of int64 start, int32 length and int64 offset (20
    bytes a row), one int64 key written per window. A frozen copy of
    chip_smoke.py:410."""
    return codes + 20 * rows + 8 * windows


def dense_launch_bytes(codes: int, windows: int) -> int:
    """One launch of the extraction kernel's dense (B, L) entry: int8 codes
    read once, one int64 key written per window (chip_smoke.py:435)."""
    return codes + 8 * windows


def consolidate_bytes(store_in: int, lanes: int, store_out: int) -> int:
    """One consolidation: the sorted store of int64 keys and int32 counts
    read once, the buffer's filled int64 lanes read once, the new store
    written once."""
    return 12 * store_in + 8 * lanes + 12 * store_out
