"""ReadsFilter: extract reads touching an environment subgraph.

Reimplements src/algo/ReadsFilter.java:34-77: stream a reads file, keep each
read whose count of subgraph k-mers reaches max(1, kmersInRead*percent/100),
write kept reads as '>readsNumber|index' FASTA records. Carried over from
metacherchant_tpu/algo/filter.py, which tests one read at a time; here a
batch of reads, padded to its longest, goes through one rolling-key sweep
and one searchsorted. Reference quirks kept:
- the window loop runs i in [0, len-k) -- the LAST k-mer of the read is never
  tested (:54), so a read of exactly k bases is never kept
- reads shorter than k are skipped
- reads are NOT N-split here (readDnaQLazy path); N counts as 'A', also in
  the written read
- index counts kept reads only
"""
from __future__ import annotations

import os

import numpy as np

from ..algo.classify import iter_read_batch_pairs, rolling_keys_np
from ..algo.environment import canonical_codes
from ..dna import decode

#: reads per rolling-key sweep (a (B, L) int32 code matrix and int64 keys)
FILTER_BATCH = 8192


class SubgraphChecker:
    """isContainedInSubgraph by canonical key (exact or hashed regime)."""

    def __init__(self, env_strings: list[str], k: int, hasher: str | None):
        from ..ops.kmers import hash_str
        if hasher is None:
            from ..dna import kmer_to_code
            keys = np.array(
                [kmer_to_code(s) for s in env_strings], np.int64)
            self._keys = np.sort(canonical_codes(keys, k))
        else:
            self._keys = np.sort(np.array(
                [hash_str(s, hasher) for s in env_strings], np.int64))
        self.k = k
        self.hasher = hasher

    def window_hits(self, codes: np.ndarray) -> np.ndarray:
        """(B, L) codes (N already as 0) -> (B, L-k+1) bool per window;
        windows past a row's own length are garbage."""
        keys = rolling_keys_np(codes, self.k, self.hasher)
        if self._keys.size == 0:
            return np.zeros(keys.shape, bool)
        pos = np.minimum(np.searchsorted(self._keys, keys), self._keys.size - 1)
        return self._keys[pos] == keys


def kept_rows(checker: SubgraphChecker, codes: np.ndarray,
              lengths: np.ndarray, percent_filtration: int) -> np.ndarray:
    """Bool per read of a (B, L) batch: at least max(1, (n-k+1)*pf//100)
    hits among its first n-k windows, for reads of n >= k bases."""
    k = checker.k
    n = lengths.astype(np.int64)
    hits = checker.window_hits(codes)
    tested = np.arange(hits.shape[1])[None, :] < (n - k)[:, None]
    count = (hits & tested).sum(axis=1)
    need = np.maximum(1, (n - k + 1) * percent_filtration // 100)
    return (n >= k) & (count >= need)


def filter_reads_file(reads_file: str, checker: SubgraphChecker,
                      output_prefix: str, reads_number: int,
                      percent_filtration: int,
                      batch: int = FILTER_BATCH) -> int:
    """Writes cutReads<i>.fasta; returns number of kept reads."""
    out_path = os.path.join(output_prefix, f"cutReads{reads_number}.fasta")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    index = 0
    with open(out_path, "w") as out:
        for reads, _ in iter_read_batch_pairs([reads_file], batch):
            keep = kept_rows(checker, reads.codes, reads.lengths,
                             percent_filtration)
            for i in np.flatnonzero(keep).tolist():
                index += 1
                read = decode(reads.codes[i, :reads.lengths[i]])
                out.write(f">{reads_number}|{index}\n{read}\n")
    return index
