"""Read-in-graph classification: vectorized coverage + Poisson interval test.

Reimplements src/algo/ReadsFinderInGraph.java:37-140 with whole batches of
reads processed at once: the per-read k-mer probe loop becomes a rolling
canonical-key sweep over a (B, L) code matrix and one vectorized map lookup.
Carried over from metacherchant_tpu/algo/classify.py. The coverage runs on
the host by default; MC_DEVICE_CLASSIFY (any value but "" and "0") moves key
extraction and map lookup to the torch device of device.py.

Semantics preserved exactly:
- coverage uses getWithZero (absent -> 0) over RAW read codes; reads are NOT
  N-split here and N bases count as 'A' (nuc code 0), exactly like the Java
  path that feeds DnaQ straight into ShortKmer.kmersOf (getCoverage:50-72)
- cov_mean = (sum cov + cov[last]*(k-1)) / len;  breadth 'width' counts
  cov>0 windows with the same (k-1) tail correction (findRead:42-44)
- theory_width = 1 - e^-cov_mean (getTheoryWidth:74-76); normal-approx
  interval: std = z*sqrt(e^-c(1-e^-c)/len); accept iff width==1 or
  (width!=0 and |width-theory| <= std) (delta:79-93); z = 1.96 with
  --interval95 else 1 (src/tools/ReadsClassifier.java:167)
- found iff width >= found_threshold AND interval accepts (findRead:46)
- reads shorter than k are never found (findRead:38-40)
- correction (--correction): reads with EXACTLY one phred<10 position try all
  4 nucleotides there, accepting if any variant passes with the HARDCODED 0.9
  breadth bound (findReadWithCorrection:101-140); 0 or >1 such positions fall
  back to the plain test
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import device
from ..kmer_map import KmerMap
from ..ops.extract_cuda import extract_append
from ..ops.kmers import hash_canonical_kmers


def rolling_keys_np(codes: np.ndarray, k: int, hasher: str | None) -> np.ndarray:
    """(B, L) nonneg codes -> (B, L-k+1) canonical keys (host, vectorized).

    Window j covers [j, j+k). Columns whose window exceeds a read's length are
    garbage; callers mask by window count.
    """
    B, L = codes.shape
    W = L - k + 1
    if W <= 0:
        return np.empty((B, 0), np.int64)
    if hasher is None:
        c = codes.astype(np.uint64)
        out = np.empty((B, W), np.int64)
        mask = np.uint64((1 << (2 * k)) - 1)
        shift = np.uint64(2 * k - 2)
        two = np.uint64(2)
        three = np.uint64(3)
        fw = np.zeros(B, np.uint64)
        rc = np.zeros(B, np.uint64)
        for j in range(L):
            col = c[:, j]
            fw = ((fw << two) | col) & mask
            rc = (rc >> two) | ((three - col) << shift)
            if j >= k - 1:
                out[:, j - k + 1] = np.minimum(fw, rc).astype(np.int64)
        return out
    # windowed 64-bit hashes: the keys of window starts 0..L-k, which
    # hash_canonical_kmers writes at window ends k-1..L-1
    keys = hash_canonical_kmers(torch.from_numpy(codes), k, hasher)[0]
    return keys[:, k - 1:].numpy()


@dataclass
class ReadBatch:
    """Padded batch of reads: codes with N->0, per-read lengths and phreds."""
    codes: np.ndarray   # (B, L) int8/int32, pad 0
    lengths: np.ndarray  # (B,) int32
    phred: np.ndarray   # (B, L) int16, pad large

    @staticmethod
    def from_dnaqs(dnaqs) -> "ReadBatch":
        B = len(dnaqs)
        L = max((len(d) for d in dnaqs), default=1) or 1
        codes = np.zeros((B, L), np.int32)
        phred = np.full((B, L), 99, np.int16)
        lengths = np.zeros(B, np.int32)
        for i, d in enumerate(dnaqs):
            n = len(d)
            lengths[i] = n
            codes[i, :n] = d.codes
            phred[i, :n] = d.phred
        return ReadBatch(codes, lengths, phred)


def _pack_flat(codes: np.ndarray, phred: np.ndarray, offs: np.ndarray,
               lo: int, hi: int) -> ReadBatch:
    """Vectorized (B, L) packing of flat-parsed reads [lo, hi)."""
    lens = (offs[lo + 1:hi + 1] - offs[lo:hi]).astype(np.int32)
    starts = offs[lo:hi]
    B = hi - lo
    L = max(int(lens.max()) if B and lens.size else 1, 1)
    ar = np.arange(L, dtype=np.int64)
    mask = ar[None, :] < lens[:, None]
    src = starts[:, None] + ar[None, :]
    c = np.zeros((B, L), np.int32)
    p = np.full((B, L), 99, np.int16)
    c[mask] = codes[src[mask]]
    p[mask] = phred[src[mask]]
    return ReadBatch(c, lens, p)


def _empty_batch(B: int) -> ReadBatch:
    return ReadBatch(np.zeros((B, 1), np.int32), np.zeros(B, np.int32),
                     np.full((B, 1), 99, np.int16))


def iter_read_batch_pairs(files: list[str], batch: int):
    """Stream paired reads as ReadBatch pairs.

    Fast path: whole-file native C++ parse (native.parse_reads -- whole
    reads, NO N-splitting, iter_dnaq semantics) + vectorized (B, L)
    packing; zero per-read Python. Falls back to the DnaQ-object reader for
    formats the native parser does not handle (BINQ, bz2) or when
    MC_NATIVE_IO=0. PairSource semantics as iter_dnaq_pair_batches
    (itmo:io/sources/PairSource.java:22-57): the shorter source continues
    against empty mates; a single file pairs every read with an empty mate.
    """
    from .. import native
    from ..io.readers import (detect_file_format, determine_quality_format,
                              iter_dnaq_pair_batches)

    # whole-file native parse holds ~3 bytes/base (int8 codes + int16 phred)
    # -- a small constant vs ~400+ B/read for DnaQ object lists, but still
    # O(file); truly large files stay on the streaming DnaQ path
    max_bytes = int(os.environ.get("MC_NATIVE_READS_MAX_BYTES",
                                   str(2 << 30)))

    def _native_parse(path):
        try:
            fmt = detect_file_format(path)
        except IOError:
            return None
        if fmt.split(".")[0] != "fastq" or not (native.supports(fmt)
                                                and native.available()):
            return None
        try:
            size = os.path.getsize(path)
            # the cap bounds HOST MEMORY (~3 bytes/base of decoded arrays),
            # so compare the DECOMPRESSED size: gzip files expand ~4x for
            # FASTQ text, so divide the cap accordingly (ADVICE r4: a .gz
            # just under the byte cap can expand to ~8-16 GiB of arrays)
            budget = max_bytes // 4 if path.endswith(".gz") else max_bytes
            if size > budget:
                return None
        except OSError:
            return None
        qoffset = 33 if determine_quality_format(path) == "sanger" else 64
        try:
            return native.parse_reads(path, qoffset)
        except native.NativeIOError:
            return None

    parsed = [_native_parse(f) for f in files[:2]]
    if any(p is None for p in parsed):
        for reads1, reads2 in iter_dnaq_pair_batches(files, batch):
            yield (ReadBatch.from_dnaqs(reads1), ReadBatch.from_dnaqs(reads2))
        return

    if len(parsed) == 1:
        (c1, p1, o1), = parsed
        n1, n2 = o1.size - 1, 0
    else:
        (c1, p1, o1), (c2, p2, o2) = parsed
        n1, n2 = o1.size - 1, o2.size - 1
    n = max(n1, n2)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        if lo < n1:
            b1 = _pack_flat(c1, p1, o1, lo, min(hi, n1))
            if hi > n1:  # pad exhausted side with empty mates
                pad = _empty_batch(hi - n1)
                b1 = ReadBatch(
                    _pad_rows(b1.codes, pad.codes),
                    np.concatenate([b1.lengths, pad.lengths]),
                    _pad_rows(b1.phred, pad.phred))
        else:
            b1 = _empty_batch(hi - lo)
        if n2 > lo:
            b2 = _pack_flat(c2, p2, o2, lo, min(hi, n2))
            if hi > n2:
                pad = _empty_batch(hi - n2)
                b2 = ReadBatch(
                    _pad_rows(b2.codes, pad.codes),
                    np.concatenate([b2.lengths, pad.lengths]),
                    _pad_rows(b2.phred, pad.phred))
        else:
            b2 = _empty_batch(hi - lo)
        yield b1, b2


def _pad_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Stack row blocks with different widths (zero-pad the narrower; the
    padded region is always masked off by per-read lengths downstream)."""
    w = max(a.shape[1], b.shape[1])
    if a.shape[1] < w:
        a = np.pad(a, ((0, 0), (0, w - a.shape[1])))
    if b.shape[1] < w:
        b = np.pad(b, ((0, 0), (0, w - b.shape[1])))
    return np.concatenate([a, b])


def _coverage_stats(cov: np.ndarray, lengths: np.ndarray, k: int):
    """cov (B, W) with garbage beyond n_i = len_i - k + 1 windows.
    Returns (cov_mean, width) per read; reads with len < k get 0s."""
    B, W = cov.shape
    if W == 0:  # every read shorter than k (e.g. all-empty mate batch)
        zeros = np.zeros(B, np.float64)
        return zeros, zeros.copy(), np.zeros(B, bool)
    n = np.maximum(lengths - k + 1, 0)
    col = np.arange(W)[None, :]
    valid = col < n[:, None]
    covv = np.where(valid, cov, 0)
    pos = covv > 0
    last_idx = np.clip(n - 1, 0, max(W - 1, 0))
    last = cov[np.arange(B), last_idx]
    has = n > 0
    lengths_f = np.maximum(lengths, 1).astype(np.float64)
    cov_mean = (covv.sum(axis=1) + last * (k - 1)) / lengths_f
    width = (pos.sum(axis=1) + (last > 0) * (k - 1)) / lengths_f
    return np.where(has, cov_mean, 0.0), np.where(has, width, 0.0), has


def _interval_ok(cov_mean, width, lengths, z):
    """delta (ReadsFinderInGraph.java:79-93)."""
    with np.errstate(over="ignore"):
        p = np.exp(-cov_mean)
    std = z * np.sqrt(p * (1 - p) / np.maximum(lengths, 1))
    theory = 1.0 - p
    dev = width - theory
    return (width == 1) | ((width != 0) & (-std <= dev) & (dev <= std))


def batch_widths(batch: ReadBatch, kmap: KmerMap, k: int,
                 hasher: str | None) -> np.ndarray:
    """getWidth (TripleFinder.java:64-70): breadth only; len<k -> 0."""
    cov = _coverage(batch, kmap, k, hasher)
    _, width, has = _coverage_stats(cov, batch.lengths, k)
    return np.where(has, width, 0.0)


def device_classify() -> bool:
    """MC_DEVICE_CLASSIFY switch: unset, "" and "0" are off (the JAX
    package takes any non-empty value, "0" included, as on)."""
    return os.environ.get("MC_DEVICE_CLASSIFY", "") not in ("", "0")


def _coverage(batch: ReadBatch, kmap: KmerMap, k: int,
              hasher: str | None) -> np.ndarray:
    if device_classify() and batch.codes.shape[1] >= k:
        return _coverage_device(batch, kmap, k, hasher)
    keys = rolling_keys_np(batch.codes, k, hasher)
    if keys.size == 0:
        return np.zeros((batch.codes.shape[0], 0), np.int32)
    cov = kmap.get_many(keys)
    return np.maximum(cov, 0)  # getWithZero


def _coverage_device(batch: ReadBatch, kmap: KmerMap, k: int,
                     hasher: str | None) -> np.ndarray:
    """Device coverage (SURVEY §2.3 P3): canonical keys of every window start
    and the sorted-map probe on the device of device.py, one batch at a time.
    Codes are N->0 and padded with 0 (=A), so every window is valid; garbage
    windows beyond each read's length are masked later by _coverage_stats,
    as on the host. Exact keys come from ops/extract_cuda.extract_append
    (the CUDA kernel on a GPU), hashed keys from hash_canonical_kmers."""
    codes = torch.from_numpy(batch.codes).to(device(), torch.int8)
    B, L = codes.shape
    if hasher is None:
        keys = torch.empty(B * (L - k + 1), dtype=torch.int64,
                           device=codes.device)
        extract_append(codes.contiguous(), k, keys)
    else:
        keys = hash_canonical_kmers(codes, k, hasher)[0][:, k - 1:]
    cov = kmap.lookup_device(keys.reshape(-1)).reshape(B, L - k + 1)
    return np.maximum(cov.cpu().numpy(), 0)


def find_reads(batch: ReadBatch, kmap: KmerMap, k: int, hasher: str | None,
               z: float, found_threshold: float,
               do_correction: bool = False) -> np.ndarray:
    """Vectorized findRead / findReadWithCorrection over a batch."""
    cov = _coverage(batch, kmap, k, hasher)
    cov_mean, width, has = _coverage_stats(cov, batch.lengths, k)
    ok = _interval_ok(cov_mean, width, batch.lengths, z)
    found = has & ~(width < found_threshold) & ok
    if not do_correction:
        return found

    # correction: reads with exactly one phred<10 position among first len chars
    col = np.arange(batch.codes.shape[1])[None, :]
    in_read = col < batch.lengths[:, None]
    bad = (batch.phred < 10) & in_read
    n_bad = bad.sum(axis=1)
    candidates = np.flatnonzero((n_bad == 1) & has)
    for i in candidates:
        pos = int(np.flatnonzero(bad[i])[0])
        corrected = False
        for nuc in range(4):
            variant = batch.codes[i:i + 1].copy()
            variant[0, pos] = nuc
            vb = ReadBatch(variant, batch.lengths[i:i + 1], batch.phred[i:i + 1])
            vcov = _coverage(vb, kmap, k, hasher)
            m, w, h = _coverage_stats(vcov, vb.lengths, k)
            if h[0] and not (w[0] < 0.9) and _interval_ok(m, w, vb.lengths, z)[0]:
                corrected = True
                break
        found[i] = corrected
    return found


def classify_pairs(found_1: np.ndarray, found_2: np.ndarray,
                   len_2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Single-end convention: empty mate -> found_2 = !found_1
    (PairFinder.java:42-44)."""
    found_2 = np.where(len_2 == 0, ~found_1, found_2)
    return found_1, found_2


@dataclass
class FoundStats:
    """src/tools/ReadsClassifier.java FoundStats:225-268."""
    both_found: int
    first_found: int
    second_found: int
    both_not_found: int

    @property
    def total(self):
        return 2 * (self.both_found + self.first_found + self.second_found
                    + self.both_not_found)

    @property
    def found(self):
        return 2 * self.both_found + self.first_found + self.second_found

    @property
    def not_found(self):
        return 2 * self.both_not_found + self.first_found + self.second_found

    @property
    def paired(self):
        return 2 * (self.both_found + self.both_not_found)

    @property
    def quality_found(self):
        d = self.both_found * 2 + self.first_found + self.second_found
        return self.both_found * 2 / d * 100 if d else math.nan

    @property
    def quality_not_found(self):
        d = self.both_not_found * 2 + self.first_found + self.second_found
        return self.both_not_found * 2 / d * 100 if d else math.nan



# triple-classifier verdicts (TripleReadsClassifier.FindResult:272-274)
FOUND, HALF_FOUND, NOT_FOUND = 2, 1, 0


def triple_verdict_pass1(found: np.ndarray, width: np.ndarray,
                         half_threshold: float) -> np.ndarray:
    """TripleFinder.run (src/algo/TripleFinder.java:47-60)."""
    return np.where(found, FOUND,
                    np.where(width >= half_threshold, HALF_FOUND, NOT_FOUND))


def triple_verdict_pass2(found: np.ndarray, width2: np.ndarray,
                         pass1: np.ndarray, half_threshold: float) -> np.ndarray:
    """TripleFinder2.run combination (src/algo/TripleFinder2.java:63-80)."""
    res = np.full(found.shape, NOT_FOUND, np.int32)
    res[found & (pass1 == FOUND)] = FOUND
    half = (~(found & (pass1 == FOUND))) & (
        found | (pass1 == FOUND)
        | ((width2 >= half_threshold) & (pass1 == HALF_FOUND)))
    res[half] = HALF_FOUND
    return res
