"""Rolling canonical k-mer extraction over batched reads, in torch.

Counterpart of metacherchant_tpu/ops/kmers.py. Keying regimes
(src/tools/EnvironmentFinderMain.java:127-154):

- exact (k <= 31): canonical key = min(fw, rc) of the 2-bit packed forward
  and reverse-complement codes (itmo:utils/KmerUtils.java:59-61; the rolling
  update is itmo:dna/kmers/ShortKmer.java:68-71);
- poly (k > 31 or --forcehash): base-5 polynomial with seed 1; rc uses
  3^code in forward order of the rc string (src/utils/PolynomialHash.java:7-28);
- fnv1a: FNV-1a with offset basis 14695981039346656037 and prime
  1099511628211 (src/utils/FNV1AHash.java:8-42).

Hashed keys are the signed min(fw, rc) of Java longs. torch has no uint64
shift, compare or minimum on the CPU, so the hashed code is int64 only: the
constants are wrapped into int64 (_i64) and the sums and products wrap mod
2^64 as two's-complement int64 does.

Input layout: (B, L) integer code matrix, entries 0..3, padding and N = -1.
Column j carries the key of window [j-k+1, j] once j >= k-1 and the trailing
run of valid codes is >= k; every other position carries SENTINEL.

exact_canonical_kmers is the plain version of the CUDA extraction kernel
(ops/extract_cuda.py) and runs on any device; hash_canonical_kmers is plain
torch on any device; canonical_kmers dispatches between the kernel and
hash_canonical_kmers as the JAX package's canonical_kmers does (its
MC_PALLAS_EXTRACT switch is a TPU's and is not read here).
"""
from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1
SENTINEL = int(np.iinfo(np.int64).max)

FNV_OFFSET_BASIS = 14695981039346656037
FNV_PRIME = 1099511628211
POLY_BASE = 5


def _i64(x: int) -> int:
    """Python int (mod 2^64) -> the int64 value of the same bits."""
    x &= MASK64
    return x - (1 << 64) if x >= 1 << 63 else x


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


def _powers(L: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(5^m, 5^-m) mod 2^64 for m = 0..L, as wrapped int64 tensors."""
    inv5 = pow(POLY_BASE, -1, 1 << 64)
    pow5 = np.empty(L + 1, np.uint64)
    invp = np.empty(L + 1, np.uint64)
    p = q = 1
    for m in range(L + 1):
        pow5[m], invp[m] = p, q
        p = (p * POLY_BASE) & MASK64
        q = (q * inv5) & MASK64
    return (torch.from_numpy(pow5.view(np.int64)).to(device),
            torch.from_numpy(invp.view(np.int64)).to(device))


def _poly_window_keys(cpad: torch.Tensor, k: int) -> torch.Tensor:
    """Polynomial canonical key of the window starting at each column, in
    closed form (the JAX package's _poly_windowed_hash). With seed 1 and
    arithmetic mod 2^64 (src/utils/PolynomialHash.java:19-28):
        fw(i) = 5^k + sum_t code[i+t] * 5^(k-1-t)
        rc(i) = 5^k + sum_u (3^code[i+u]) * 5^u
    5 is odd, hence invertible mod 2^64, so with P(j) = sum_{m<j}
    code[m]*inv5^m and Q(j) = sum_{m<j} (3^code[m])*5^m:
        fw(i) = 5^k + 5^(i+k-1) * (P(i+k) - P(i))
        rc(i) = 5^k + inv5^i    * (Q(i+k) - Q(i))
    Columns whose window runs past the row are garbage; callers mask them."""
    B, L = cpad.shape
    pow5, invp = _powers(L, cpad.device)
    zero = cpad.new_zeros((B, 1))
    P = torch.cat([zero, torch.cumsum(cpad * invp[:L], dim=1)], dim=1)
    Q = torch.cat([zero, torch.cumsum((cpad ^ 3) * pow5[:L], dim=1)], dim=1)
    p5k = _i64(pow(POLY_BASE, k, 1 << 64))
    i = torch.arange(L, device=cpad.device)
    i_end = (i + k).clamp_max(L)
    fw = p5k + pow5[(i + k - 1).clamp_max(L)] * (P[:, i_end] - P[:, i])
    rc = p5k + invp[i] * (Q[:, i_end] - Q[:, i])
    return torch.minimum(fw, rc)


def _fnv1a_window_keys(cpad: torch.Tensor, k: int) -> torch.Tensor:
    """FNV-1a canonical key of the window starting at each column: k
    xor-multiply steps, fw over code[i+t] and rc over 3^code[i+k-1-t]
    (src/utils/FNV1AHash.java:33-42). FNV-1a has no sliding form. Columns
    whose window runs past the row are garbage; callers mask them."""
    B, L = cpad.shape
    ext = torch.cat([cpad, cpad.new_zeros((B, k - 1))], dim=1)
    prime = FNV_PRIME
    fw = torch.full((B, L), _i64(FNV_OFFSET_BASIS), dtype=torch.int64,
                    device=cpad.device)
    rc = fw.clone()
    for t in range(k):
        fw = (fw ^ ext[:, t:t + L]) * prime
        rc = (rc ^ (ext[:, k - 1 - t:k - 1 - t + L] ^ 3)) * prime
    return torch.minimum(fw, rc)


def hash_canonical_kmers(codes: torch.Tensor, k: int, hash_name: str
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hashed-regime keys for k of any size, hash_name in {'poly', 'fnv1a'}:
    (B, L) codes -> ((B, L) int64 keys at window ends, (B, L) validity)."""
    if hash_name not in ("poly", "fnv1a"):
        raise ValueError(f"unknown hash {hash_name}")
    if k < 1:
        raise ValueError(f"k must be positive; got {k}")
    cpad = codes.to(torch.int64).clamp_min(0)
    window = _poly_window_keys if hash_name == "poly" else _fnv1a_window_keys
    keys_start = window(cpad, k)
    ok = _valid_window_mask(codes, k)
    keys = torch.roll(keys_start, k - 1, dims=1)
    return keys.masked_fill_(~ok, SENTINEL), ok


def canonical_kmers(codes: torch.Tensor, k: int, hasher: str | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys of a (B, L) code batch per the reference's regime selection
    (src/tools/EnvironmentFinderMain.java:127-154), as the JAX dispatch:
    hasher None -> exact keys from B1 (the CUDA kernel of ops/extract_cuda
    on a CUDA tensor, its plain version on a CPU one), else
    hash_canonical_kmers. Returns ((B, L) int64 keys, SENTINEL where no
    window ends, (B, L) validity)."""
    if hasher is not None:
        return hash_canonical_kmers(codes, k, hasher)
    from .extract_cuda import extract_append
    B, L = codes.shape
    keys = torch.full((B, L), SENTINEL, dtype=torch.int64, device=codes.device)
    if L >= k and B:
        out = torch.empty(B * (L - k + 1), dtype=torch.int64,
                          device=codes.device)
        extract_append(codes.to(torch.int8).contiguous(), k, out)
        keys[:, k - 1:] = out.view(B, L - k + 1)
    return keys, keys != SENTINEL


# ---------------------------------------------------------------------------
# Host (numpy/python) helpers -- BFS seeding, writers and oracles
# ---------------------------------------------------------------------------

def _signed(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def hash_codes_pair_np(codes: np.ndarray, hasher: str
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Pre-min (fw, rc) hash pair of (N, k) code rows as uint64 bit patterns.

    Exact Java long semantics via uint64 wraparound (fused fw/rc loops,
    src/utils/PolynomialHash.java:19-28, src/utils/FNV1AHash.java:33-42).
    The sliding-poly BFS (algo/environment_hashed._bfs_scalar_poly) seeds
    its per-state (fw, rc) registers from it; hash_canonical_kmers is the
    batched torch form over reads."""
    codes = np.asarray(codes, np.uint64)
    n, k = codes.shape
    if hasher == "poly":
        fw = np.ones(n, np.uint64)
    elif hasher == "fnv1a":
        fw = np.full(n, np.uint64(FNV_OFFSET_BASIS & MASK64))
    else:
        raise ValueError(hasher)
    rc = fw.copy()
    prime = np.uint64(FNV_PRIME)
    five = np.uint64(POLY_BASE)
    three = np.uint64(3)
    with np.errstate(over="ignore"):
        for t in range(k):
            cf = codes[:, t]
            cr = codes[:, k - 1 - t] ^ three
            if hasher == "poly":
                fw = fw * five + cf
                rc = rc * five + cr
            else:
                fw = (fw ^ cf) * prime
                rc = (rc ^ cr) * prime
    return fw, rc


def hash_codes_np(codes: np.ndarray, hasher: str) -> np.ndarray:
    """Canonical hash of (N, k) nucleotide-code rows: signed min(fw, rc) of
    the Java longs (src/utils/AbstractHashFunction.java + the hash classes).
    Per row equal to hash_str of the row's string."""
    fw, rc = hash_codes_pair_np(codes, hasher)
    return np.minimum(fw.view(np.int64), rc.view(np.int64))


def codes_matrix_of_kmer_strings(kmers: list[str], k: int) -> np.ndarray:
    """(N, k) int8 nucleotide codes of equal-length plain-ACGT strings."""
    from ..dna import CHAR_TO_CODE
    raw = np.frombuffer("".join(kmers).encode("ascii"), np.uint8)
    return CHAR_TO_CODE[raw].reshape(len(kmers), k)


def fw_codes_of_kmer_strings(kmers: list[str], k: int) -> np.ndarray:
    """Vectorized kmer_to_code over N strings: 2-bit packed forward codes."""
    if not kmers:
        return np.empty(0, np.int64)
    codes = codes_matrix_of_kmer_strings(kmers, k).astype(np.uint64)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    return (codes << shifts[None, :]).sum(axis=1, dtype=np.uint64).view(np.int64)


def keys_of_kmer_strings(kmers: list[str], k: int, hasher: str | None
                         ) -> np.ndarray:
    """Vectorized hash_str over N equal-length plain-ACGT k-mer strings:
    canonical 2-bit code min(fw, rc) (itmo:utils/KmerUtils.java:59-61) in the
    exact regime, canonical poly/FNV-1a (hash_codes_np) in the hashed one."""
    if not kmers:
        return np.empty(0, np.int64)
    codes = codes_matrix_of_kmer_strings(kmers, k)
    if hasher is not None:
        return hash_codes_np(codes, hasher)
    u = codes.astype(np.uint64)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    fw = (u << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    rshifts = (2 * np.arange(k)).astype(np.uint64)
    rc = ((u ^ np.uint64(3)) << rshifts[None, :]).sum(axis=1, dtype=np.uint64)
    return np.minimum(fw.view(np.int64), rc.view(np.int64))


def poly_hash_str(s: str) -> int:
    """Reference polynomial hash of one k-mer string
    (src/utils/PolynomialHash.java:7-16)."""
    from ..dna import CHAR_TO_CODE
    fw = rc = 1
    n = len(s)
    for i in range(n):
        fw = (fw * 5 + int(CHAR_TO_CODE[ord(s[i])])) & MASK64
        rc = (rc * 5 + (3 ^ int(CHAR_TO_CODE[ord(s[n - 1 - i])]))) & MASK64
    return min(_signed(fw), _signed(rc))


def fnv1a_hash_str(s: str) -> int:
    """Reference FNV-1a hash of one k-mer string
    (src/utils/FNV1AHash.java:21-31)."""
    from ..dna import CHAR_TO_CODE
    fw = rc = FNV_OFFSET_BASIS
    n = len(s)
    for i in range(n):
        fw = ((fw ^ int(CHAR_TO_CODE[ord(s[i])])) * FNV_PRIME) & MASK64
        rc = ((rc ^ (3 ^ int(CHAR_TO_CODE[ord(s[n - 1 - i])]))) * FNV_PRIME
              ) & MASK64
    return min(_signed(fw), _signed(rc))


def hash_str(s: str, hasher: str | None) -> int:
    """Canonical key of a k-mer string under the given regime (host)."""
    if hasher is None:
        from ..dna import kmer_to_code, canonical_code
        return _signed(canonical_code(kmer_to_code(s), len(s)))
    if hasher == "poly":
        return poly_hash_str(s)
    if hasher == "fnv1a":
        return fnv1a_hash_str(s)
    raise ValueError(hasher)


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
