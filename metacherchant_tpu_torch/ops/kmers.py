"""Rolling canonical k-mer extraction over batched reads, in torch.

Counterpart of metacherchant_tpu/ops/kmers.py for the exact regime
(k <= 31): the canonical key of a window is min(fw, rc) of its 2-bit packed
forward and reverse-complement codes (itmo:utils/KmerUtils.java:59-61; the
rolling update is itmo:dna/kmers/ShortKmer.java:68-71).

Input layout: (B, L) integer code matrix, entries 0..3, padding and N = -1.
Column j carries the key of window [j-k+1, j] once j >= k-1 and the trailing
run of valid codes is >= k; every other position carries SENTINEL.

exact_canonical_kmers is the plain version of the CUDA extraction kernel
(ops/extract_cuda.py) and runs on any device. The hashed regime (k > 31 or
--forcehash) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

SENTINEL = int(np.iinfo(np.int64).max)

_HASHED = "hashed regime not yet ported"


def _valid_window_mask(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L) bool: True at column j iff codes[:, j-k+1..j] are all >= 0.

    run[j] = j - max_{i<=j}(i if invalid else -1), via a cummax."""
    L = codes.shape[1]
    col = torch.arange(L, device=codes.device).expand_as(codes)
    last_bad = torch.cummax(torch.where(codes < 0, col, -1), dim=1).values
    return col - last_bad >= k


def exact_canonical_kmers(codes: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L) codes -> ((B, L) int64 canonical keys, (B, L) bool validity).

    One step per column carries (fw, rc) for every read, as the JAX scan
    does. Both registers stay below 2^62, so int64 shifts and the signed
    minimum equal their unsigned counterparts."""
    if not 1 <= k <= 31:
        raise ValueError(f"exact keys need 1 <= k <= 31; got {k}")
    B, L = codes.shape
    mask = (1 << (2 * k)) - 1
    shift_hi = 2 * k - 2
    cc = codes.to(torch.int64).clamp_min(0)
    fw = torch.zeros(B, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fw)
    keys = torch.empty((B, L), dtype=torch.int64, device=codes.device)
    for j in range(L):
        c = cc[:, j]
        fw = ((fw << 2) | c) & mask
        rc = (rc >> 2) | ((3 - c) << shift_hi)
        keys[:, j] = torch.minimum(fw, rc)
    ok = _valid_window_mask(codes, k)
    return keys.masked_fill_(~ok, SENTINEL), ok


# ---------------------------------------------------------------------------
# Host (numpy/python) helpers -- BFS seeding, writers and oracles
# ---------------------------------------------------------------------------

def _signed(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def keys_of_kmer_strings(kmers: list[str], k: int, hasher: str | None
                         ) -> np.ndarray:
    """Vectorized hash_str over N equal-length plain-ACGT k-mer strings:
    canonical 2-bit code min(fw, rc) (itmo:utils/KmerUtils.java:59-61)."""
    if hasher is not None:
        raise NotImplementedError(_HASHED)
    if not kmers:
        return np.empty(0, np.int64)
    from ..dna import CHAR_TO_CODE
    raw = np.frombuffer("".join(kmers).encode("ascii"), np.uint8)
    u = CHAR_TO_CODE[raw].reshape(len(kmers), k).astype(np.uint64)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    fw = (u << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    rshifts = (2 * np.arange(k)).astype(np.uint64)
    rc = ((u ^ np.uint64(3)) << rshifts[None, :]).sum(axis=1, dtype=np.uint64)
    return np.minimum(fw.view(np.int64), rc.view(np.int64))


def hash_str(s: str, hasher: str | None) -> int:
    """Canonical key of a k-mer string (host)."""
    if hasher is not None:
        raise NotImplementedError(_HASHED)
    from ..dna import kmer_to_code, canonical_code
    return _signed(canonical_code(kmer_to_code(s), len(s)))


def pack_reads(fragments: list[np.ndarray], batch: int, length: int
               ) -> np.ndarray:
    """Pad a list of code arrays into a (batch, length) int8 matrix (pad -1).

    int8, where the JAX package packs int32: the extraction kernel reads one
    byte per code. Fragments longer than `length` must be pre-chunked with
    k-1 overlap by the caller (counting._chunk_fragment)."""
    out = np.full((batch, length), -1, np.int8)
    for i, frag in enumerate(fragments):
        out[i, : len(frag)] = frag
    return out
