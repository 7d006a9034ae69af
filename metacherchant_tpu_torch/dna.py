"""Host-side DNA primitives: 2-bit encoding, reverse complement, canonicalization.

Encoding follows the reference semantics (A=0, G=1, C=2, T=3; complement = 3-b,
itmo:dna/DnaTools.java:46-64, NUCLEOTIDES {'A','G','C','T'}). Carried over
from metacherchant_tpu/dna.py (numpy only), keeping what the port calls.

Two distinct canonical orderings exist in the reference and both are preserved here:

* numeric canonical key  = min(fw_code, rc_code) over the 2-bit packed integer
  (itmo:utils/KmerUtils.java:59-61) -- used as the hash-map key for k <= 31.
* string canonicalization = lexicographic min(s, revcomp(s)) over ASCII characters
  (A < C < G < T !), used for graph.txt keys and GFA orientation
  (src/utils/StringUtils.java:34-41).

These deliberately disagree on which orientation is "canonical" (G sorts before C
numerically but after it in ASCII); both are stable maps from {s, rc(s)}.
"""
from __future__ import annotations

import numpy as np

# Nucleotide order used for numeric codes and neighbor generation
# (itmo:dna/DnaTools.java:33: NUCLEOTIDES = {'A','G','C','T'}).
NUCLEOTIDES = "AGCT"
CODE_TO_CHAR = np.frombuffer(b"AGCT", dtype=np.uint8)

# char -> 2-bit code; N/n/. -> -1 (split marker); other -> -2 (invalid)
CHAR_TO_CODE = np.full(256, -2, dtype=np.int8)
for _i, _c in enumerate(NUCLEOTIDES):
    CHAR_TO_CODE[ord(_c)] = _i
    CHAR_TO_CODE[ord(_c.lower())] = _i
for _c in "Nn.":
    CHAR_TO_CODE[ord(_c)] = -1

_COMPLEMENT_TRANS = bytes.maketrans(b"ACGTacgt", b"TGCATGCA")


def reverse_complement(seq: str) -> str:
    """Reverse complement of an ACGT string (itmo:dna/DnaTools.java:139-145)."""
    return seq.translate(_COMPLEMENT_TRANS)[::-1]


def normalize(seq: str) -> str:
    """Lexicographic min(s, rc(s)) over ASCII chars (src/utils/StringUtils.java:34-41)."""
    rc = reverse_complement(seq)
    return seq if seq < rc else rc


def kmer_to_code(kmer: str) -> int:
    """2-bit pack, first nucleotide in the highest bits (itmo:utils/KmerUtils.java:24-40)."""
    res = 0
    for ch in kmer:
        res = (res << 2) | int(CHAR_TO_CODE[ord(ch)])
    return res


def revcomp_code(code: int, k: int) -> int:
    """Branchless 64-bit reverse complement of a packed k-mer
    (itmo:utils/KmerUtils.java:12-22): swizzle 2/4/8/16/32, invert, shift."""
    code &= (1 << 64) - 1
    code = ((code & 0x3333333333333333) << 2) | ((code & 0xCCCCCCCCCCCCCCCC) >> 2)
    code = ((code & 0x0F0F0F0F0F0F0F0F) << 4) | ((code & 0xF0F0F0F0F0F0F0F0) >> 4)
    code = ((code & 0x00FF00FF00FF00FF) << 8) | ((code & 0xFF00FF00FF00FF00) >> 8)
    code = ((code & 0x0000FFFF0000FFFF) << 16) | ((code & 0xFFFF0000FFFF0000) >> 16)
    code = ((code & 0x00000000FFFFFFFF) << 32) | ((code & 0xFFFFFFFF00000000) >> 32)
    code = ~code & ((1 << 64) - 1)
    return code >> (64 - 2 * k)


def canonical_code(code: int, k: int) -> int:
    """min(code, revcomp) -- the exact-regime map key (itmo:utils/KmerUtils.java:59-61)."""
    return min(code, revcomp_code(code, k))


# ---------------------------------------------------------------------------
# Vectorized numpy variants (host oracle / writer-side bulk work)
# ---------------------------------------------------------------------------

def revcomp_codes_np(codes: np.ndarray, k: int) -> np.ndarray:
    """Vectorized revcomp_code on uint64 arrays."""
    c = codes.astype(np.uint64)
    c = ((c & np.uint64(0x3333333333333333)) << np.uint64(2)) | (
        (c & np.uint64(0xCCCCCCCCCCCCCCCC)) >> np.uint64(2))
    c = ((c & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | (
        (c & np.uint64(0xF0F0F0F0F0F0F0F0)) >> np.uint64(4))
    c = ((c & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | (
        (c & np.uint64(0xFF00FF00FF00FF00)) >> np.uint64(8))
    c = ((c & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | (
        (c & np.uint64(0xFFFF0000FFFF0000)) >> np.uint64(16))
    c = ((c & np.uint64(0x00000000FFFFFFFF)) << np.uint64(32)) | (
        (c & np.uint64(0xFFFFFFFF00000000)) >> np.uint64(32))
    c = ~c
    return (c >> np.uint64(64 - 2 * k)).astype(codes.dtype)


def codes_to_kmers_np(codes: np.ndarray, k: int) -> list[str]:
    """Bulk decode packed k-mer codes to strings.

    One decode of the whole char matrix + cheap substring slices -- ~3x the
    per-row tobytes/decode loop on 100K-kmer environments."""
    codes = np.asarray(codes, dtype=np.uint64)
    shifts = np.arange(k - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    nucs = (codes[:, None] >> shifts[None, :]) & np.uint64(3)
    chars = CODE_TO_CHAR[nucs.astype(np.int64)]
    big = chars.tobytes().decode("ascii")
    return [big[i:i + k] for i in range(0, len(big), k)]
