"""K-mer counting: stream reads -> device extraction -> device counter.

Counterpart of metacherchant_tpu/counting.py for the `sort` engine, exact
regime (k <= 31): reads are packed on the host into fixed-shape (B, L) int8
code batches (native parser + vectorized chunking, or the Python readers),
moved to the device, and counted by ops/sortcount.StreamCounter. Long
fragments are chunked with k-1 overlap so every window is counted once.
count_kmers_host and seed_keys_of_sequence are the host oracles.
"""
from __future__ import annotations

import logging
import os
from typing import Iterable, Iterator

import numpy as np
import torch

from .dna import canonical_code, kmer_to_code, CHAR_TO_CODE
from .io.readers import iter_reads_split
from .kmer_map import KmerMap
from .ops.kmers import hash_str, pack_reads
from .ops.sortcount import StreamCounter

logger = logging.getLogger("metacherchant")

DEFAULT_BATCH = 4096
DEFAULT_LEN = 256

#: MC_COUNT_ENGINE values of the JAX package that the port does not have yet
_UNPORTED_ENGINES = ("hash", "merge", "chunk", "sharded")


def _chunk_fragment(frag: np.ndarray, k: int, max_len: int) -> Iterator[np.ndarray]:
    """Split a long fragment into <=max_len windows with k-1 overlap."""
    if len(frag) <= max_len:
        yield frag
        return
    stride = max_len - (k - 1)
    for start in range(0, len(frag) - (k - 1), stride):
        yield frag[start:start + max_len]


def iter_fragments(files: Iterable[str], k: int, min_len: int,
                   max_len: int) -> Iterator[np.ndarray]:
    """All countable fragments from the input files.

    min_len mirrors loadReads' minSeqLen filter applied to the whole read
    (src/io/IOUtils.java:199-214: splitting happens in the reader, the length
    filter applies per emitted fragment)."""
    for f in files:
        for frag in iter_reads_split(str(f)):
            if len(frag) < max(min_len, k):
                continue
            yield from _chunk_fragment(frag, k, max_len)


def _native_batches(path: str, k: int, min_len: int, batch: int,
                    max_len: int) -> Iterator[np.ndarray] | None:
    """Whole-file packed (batch, max_len) int8 code batches via the native
    parser + vectorized chunking/packing; None -> caller uses the Python
    per-fragment path. Chunking semantics identical to _chunk_fragment."""
    from . import native
    from .io.readers import detect_file_format, determine_quality_format
    try:
        fmt = detect_file_format(path)
    except IOError:
        return None
    if not (native.supports(fmt) and native.available()):
        return None
    qoffset = 33
    if fmt.split(".")[0] == "fastq":
        qoffset = 33 if determine_quality_format(path) == "sanger" else 64
    try:
        codes, offs = native.parse_fragments(path, fmt, qoffset)
    except native.NativeIOError as e:
        if "Invalid nucleotide" in str(e):
            from .io.readers import SequenceError
            raise SequenceError(str(e)) from None
        return None

    def gen():
        lens = np.diff(offs)
        starts = offs[:-1]
        keep = lens >= max(min_len, k)
        lens_k, starts_k = lens[keep], starts[keep]
        if lens_k.size == 0:
            return
        stride = max_len - (k - 1)
        nch = np.where(lens_k <= max_len, 1,
                       -(-(lens_k - (k - 1)) // stride)).astype(np.int64)
        frag_id = np.repeat(np.arange(starts_k.size), nch)
        first = np.repeat(np.cumsum(nch) - nch, nch)
        rank = np.arange(frag_id.size) - first
        cstart = starts_k[frag_id] + rank * stride
        clen = np.minimum(max_len, lens_k[frag_id] - rank * stride)
        ar = np.arange(max_len)
        for b0 in range(0, cstart.size, batch):
            cs, cl = cstart[b0:b0 + batch], clen[b0:b0 + batch]
            out = np.full((batch, max_len), -1, np.int8)
            mask = ar[None, :] < cl[:, None]
            src = cs[:, None] + ar[None, :]
            out[: cs.size][mask] = codes[src[mask]]
            yield out

    return gen()


def _sort_geometry(table_log2: int, batch: int, max_len: int
                   ) -> tuple[int, int]:
    """(buffer_cap, store_cap): env-pinned lane counts when
    MC_SORT_BUF_LANES / MC_SORT_STORE_LANES are set, else sized from
    table_log2 with buffer + store at an exact power of two."""
    buf_env = os.environ.get("MC_SORT_BUF_LANES")
    store_env = os.environ.get("MC_SORT_STORE_LANES")
    store_cap = int(store_env) if store_env else (1 << table_log2)
    if buf_env:
        buffer_cap = int(buf_env)
    else:
        min_buf = max((1 << (table_log2 + 2)) - store_cap,
                      2 * batch * max_len)
        total = 1 << int(np.ceil(np.log2(min_buf + store_cap)))
        buffer_cap = total - store_cap
    return buffer_cap, store_cap


def count_kmers_device(files: Iterable[str], k: int, hasher: str | None = None,
                       min_len: int = 0, batch: int = DEFAULT_BATCH,
                       max_len: int = DEFAULT_LEN, table_log2: int = 20,
                       engine: str | None = None, *,
                       device: torch.device) -> KmerMap:
    """Count canonical k-mers of all reads into a KmerMap on `device`.

    engine: 'sort' (the default and, so far, the only ported engine).
    Ingestion uses the native (C++) parser + vectorized packing per file when
    available, else the Python per-fragment readers."""
    if hasher is not None:
        raise NotImplementedError("hashed regime not yet ported")
    engine = engine or os.environ.get("MC_COUNT_ENGINE", "sort")
    if engine in _UNPORTED_ENGINES:
        raise NotImplementedError(
            f"MC_COUNT_ENGINE={engine!r} not yet ported; use 'sort'")
    if engine != "sort":
        raise ValueError(f"unknown counting engine {engine!r}")
    if batch == DEFAULT_BATCH and os.environ.get("MC_COUNT_BATCH"):
        batch = max(int(os.environ["MC_COUNT_BATCH"]), 64)
    if max_len == DEFAULT_LEN and os.environ.get("MC_COUNT_MAX_LEN"):
        # any L >= k is correct (long fragments chunk with k-1 overlap);
        # clamp to k so a value left over from a smaller-k run can never
        # produce windowless batches
        max_len = max(int(os.environ["MC_COUNT_MAX_LEN"]), k, 64)
    buffer_cap, store_cap = _sort_geometry(table_log2, batch, max_len)
    counter = StreamCounter(device, buffer_cap=buffer_cap,
                            store_cap=store_cap)

    def sink(packed: np.ndarray) -> None:
        counter.add_codes(torch.from_numpy(packed).to(device), k)

    from .progress import Progress
    files = [str(f) for f in files]
    total_bytes = sum(os.path.getsize(f) for f in files
                      if os.path.exists(f)) or None
    progress = Progress(label="reads", log_every=2_500_000,
                        total_bytes=total_bytes)
    buf: list[np.ndarray] = []

    def flush():
        if not buf:
            return
        sink(pack_reads(buf, batch, max_len))
        progress.update(len(buf))
        buf.clear()

    for f in files:
        nb = _native_batches(f, k, min_len, batch, max_len)
        if nb is not None:
            flush()  # keep batches file-aligned on the native path
            for packed in nb:
                sink(packed)
                progress.update(batch)
        else:
            for frag in iter_fragments([f], k, min_len, max_len):
                buf.append(frag)
                if len(buf) == batch:
                    flush()
        if os.path.exists(f):
            progress.advance_bytes(os.path.getsize(f))
    flush()
    keys, counts = counter.finalize()
    logger.debug("k-mers HM size = %d", len(keys))
    return KmerMap(keys, counts)


def count_kmers_host(files: Iterable[str], k: int, hasher: str | None = None,
                     min_len: int = 0) -> KmerMap:
    """Pure-host oracle counter (slow; tests and tiny inputs).

    Mirrors ShortKmer.kmersOf + addAndBound exactly (src/io/IOUtils.java:200-214).
    """
    if hasher is not None:
        raise NotImplementedError("hashed regime not yet ported")
    counts: dict[int, int] = {}
    for f in files:
        for frag in iter_reads_split(str(f)):
            if len(frag) < max(min_len, k):
                continue
            _count_codes_into(counts, frag, k)
    return KmerMap.from_dict(counts)


def _count_codes_into(counts: dict[int, int], codes: np.ndarray,
                      k: int) -> None:
    fw = 0
    rc = 0
    mask = (1 << (2 * k)) - 1
    shift = 2 * k - 2
    for i, c in enumerate(codes):
        c = int(c)
        fw = ((fw << 2) | c) & mask
        rc = (rc >> 2) | ((3 - c) << shift)
        if i >= k - 1:
            key = min(fw, rc)
            counts[key] = counts.get(key, 0) + 1


def seed_keys_of_sequence(seq: str, k: int, hasher: str | None) -> np.ndarray:
    """Canonical keys of every k-window of a sequence, in order (host)."""
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, np.int64)
    if hasher is not None:
        return np.fromiter(
            (hash_str(seq[i:i + k], hasher) for i in range(n)), np.int64, n)
    out = np.empty(n, np.int64)
    code = kmer_to_code(seq[:k])
    out[0] = canonical_code(code, k)
    mask = (1 << (2 * k)) - 1
    for i in range(1, n):
        code = ((code << 2) | int(CHAR_TO_CODE[ord(seq[i + k - 1])])) & mask
        out[i] = canonical_code(code, k)
    return out
