"""Plain recount of canonical k-mers from the benchmark's own FASTQ file.

The reference of every cell starts here. It reads the reads the benchmark
wrote (fixed-width records of A, C, G and T), and counts every k-window's
canonical key, the smaller of the forward and reverse-complement codes with
A=0, G=1, C=2, T=3 and the first base in the high bits (MetaCherchant's
ShortKmer). It is plain torch on the device it is given, and imports nothing
of the program.

key_bits narrows the key a count is merged under (a table that keeps only
that many bits of each key): the control of every cell, which must fail.
"""
from __future__ import annotations

import numpy as np
import torch

SATURATION = 32767  # counts saturate here (itmo:utils/NumUtils.java:21-26)
ROWS_PER_BLOCK = 1 << 17

_CODE = np.full(256, -1, np.int8)
for _ch, _v in zip(b"AGCT", range(4)):
    _CODE[_ch] = _v


def read_fastq_codes(path: str) -> np.ndarray:
    """(n, L) int8 codes of a FASTQ file of records that all have one
    length, reads of length L that hold only A, C, G and T."""
    buf = np.fromfile(path, np.uint8)
    ends = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], ends[:-1] + 1])
    n = ends.size // 4
    if n == 0 or ends.size != 4 * n or buf.size % n:
        raise ValueError(f"{path}: not a FASTQ file of 4-line records")
    width = buf.size // n
    rec_starts, seq_starts = starts[0::4], starts[1::4]
    off, length = int(seq_starts[0]), int(ends[1] - seq_starts[0])
    if (np.any(rec_starts != np.arange(n) * width)
            or np.any(seq_starts - rec_starts != off)
            or np.any(ends[1::4] - seq_starts != length)):
        raise ValueError(f"{path}: records of unequal layout")
    codes = _CODE[buf.reshape(n, width)[:, off:off + length]]
    if np.any(codes < 0):
        raise ValueError(f"{path}: a base other than A, C, G, T")
    return codes


def canonical_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical key of every k-window of each row of (n, L) codes, flat."""
    c = codes.to(torch.int64)
    w = c.shape[1] - k + 1
    fw = torch.zeros((c.shape[0], w), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fw)
    for j in range(k):
        col = c[:, j:j + w]
        fw = fw * 4 + col
        rc += (3 - col) << (2 * j)
    return torch.minimum(fw, rc).reshape(-1)


#: Fibonacci hashing's multiplier (2^64 over the golden ratio, as int64)
_MIX = 0x9E3779B97F4A7C15 - (1 << 64)


def narrow(keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """key_bits bits of a multiplicative hash of each key (the product
    wraps at 64 bits; the bits just above the low 32 are kept)."""
    return ((keys * _MIX) >> 32) & ((1 << key_bits) - 1)


def count(codes: np.ndarray, k: int, device: torch.device,
          key_bits: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(keys, counts) of every distinct canonical k-mer of the reads, keys
    ascending, counts saturated. With key_bits, each key gets the count of
    every key that shares its narrowed value."""
    parts = []
    for r0 in range(0, codes.shape[0], ROWS_PER_BLOCK):
        block = torch.from_numpy(codes[r0:r0 + ROWS_PER_BLOCK]).to(device)
        parts.append(canonical_keys(block, k))
    keys = torch.cat(parts)
    del parts
    uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    if key_bits is not None:
        nk, nc = torch.unique(narrow(keys, key_bits), sorted=True,
                              return_counts=True)
        counts = nc[torch.searchsorted(nk, narrow(uniq, key_bits))]
    del keys
    counts = counts.clamp_max(SATURATION)
    return uniq.cpu().numpy(), counts.cpu().numpy().astype(np.int64)


def lookup(keys: np.ndarray, counts: np.ndarray, query: np.ndarray
           ) -> np.ndarray:
    """Counts of the canonical keys `query`; -1 where absent."""
    if keys.size == 0:
        return np.full(query.shape, -1, np.int64)
    pos = np.minimum(np.searchsorted(keys, query), keys.size - 1)
    return np.where(keys[pos] == query, counts[pos], -1)
