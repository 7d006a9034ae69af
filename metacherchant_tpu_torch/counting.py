"""K-mer counting: stream reads -> device extraction -> device counter.

Counterpart of metacherchant_tpu/counting.py for the `sort` engine
(ops/sortcount.StreamCounter), the `chunk` engine
(ops/sortcount.ChunkedStreamCounter), the `merge` engine
(ops/mergecount.MergeCounter), the `hash` engine
(ops/hashtable.DeviceHashTable) and the `sharded` engine
(parallel/sharded_count.ShardedCounter), in the exact (k <= 31) and hashed
(k > 31 or --forcehash, src/io/LargeKIOUtils.java:40-88) regimes. Long
fragments are chunked with k-1 overlap so every window is counted once.
With the native parser, exact keys come from ragged rows: per launch one
contiguous slice of the parsed codes and its chunk table go to the device,
and only real windows reach the append buffer. The hashed regime and the
Python readers pack (B, L) int8 batches, -1 padded, on the host.
count_kmers_host and seed_keys_of_sequence are the host oracles;
count_kmers is the tools' choice between the host oracle (MC_HOST_COUNT)
and the device; load_present_kmer_strings recovers the strings of a hashed
map.
"""
from __future__ import annotations

import logging
import os
from typing import Iterable, Iterator

import numpy as np
import torch

from .dna import canonical_code, kmer_to_code, encode, CHAR_TO_CODE
from .io.readers import iter_reads_split
from .kmer_map import KmerMap
from .ops.kmers import hash_codes_np, pack_reads
from .ops.extract_cuda import row_offsets
from .ops.hashtable import DeviceHashTable
from .ops.mergecount import MergeCounter
from .ops.sortcount import ChunkedStreamCounter, StreamCounter

logger = logging.getLogger("metacherchant")

DEFAULT_BATCH = 4096
DEFAULT_LEN = 256


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


def _native_chunks(path: str, k: int, min_len: int, max_len: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """The whole file through the native parser, as (codes, cstart, clen):
    the parsed int8 codes and the chunk table, chunk i being
    codes[cstart[i]:cstart[i] + clen[i]]. Fragments shorter than
    max(min_len, k) are dropped and longer ones than max_len chunk with k-1
    overlap, as _chunk_fragment does. None -> the caller uses the Python
    per-fragment path."""
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
    return (codes, *_chunk_table(offs, k, min_len, max_len))


def _chunk_table(offs: np.ndarray, k: int, min_len: int, max_len: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(cstart, clen) of the chunks of the parsed fragments (fragment i is
    codes[offs[i]:offs[i+1]])."""
    lens = np.diff(offs)
    starts = offs[:-1]
    keep = lens >= max(min_len, k)
    lens_k, starts_k = lens[keep], starts[keep]
    stride = max_len - (k - 1)
    nch = np.where(lens_k <= max_len, 1,
                   -(-(lens_k - (k - 1)) // stride)).astype(np.int64)
    frag_id = np.repeat(np.arange(starts_k.size), nch)
    first = np.repeat(np.cumsum(nch) - nch, nch)
    rank = np.arange(frag_id.size) - first
    cstart = starts_k[frag_id] + rank * stride
    clen = np.minimum(max_len, lens_k[frag_id] - rank * stride)
    return cstart, clen


def _packed_batches(chunks: tuple[np.ndarray, np.ndarray, np.ndarray],
                    batch: int, max_len: int) -> Iterator[np.ndarray]:
    """The chunks packed into (batch, max_len) int8 batches, -1 padded (the
    hashed regime's input)."""
    codes, cstart, clen = chunks
    ar = np.arange(max_len)
    for b0 in range(0, cstart.size, batch):
        cs, cl = cstart[b0:b0 + batch], clen[b0:b0 + batch]
        out = np.full((batch, max_len), -1, np.int8)
        mask = ar[None, :] < cl[:, None]
        src = cs[:, None] + ar[None, :]
        out[: cs.size][mask] = codes[src[mask]]
        yield out


def _ragged_tables(chunks: tuple[np.ndarray, np.ndarray, np.ndarray],
                   batch: int, k: int
                   ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Per launch of `batch` chunks, on the host: the one contiguous slice
    of the parsed codes that holds them, their rebased table (starts, offs,
    lens) and their window count; no padding anywhere."""
    codes, cstart, clen = chunks
    for b0 in range(0, cstart.size, batch):
        cs, cl = cstart[b0:b0 + batch], clen[b0:b0 + batch]
        lo, hi = int(cs[0]), int((cs + cl).max())
        yield (codes[lo:hi], np.stack([cs - lo, row_offsets(cl, k), cl]),
               int(cl.sum()) - cl.size * (k - 1))


def _ragged_launches(chunks: tuple[np.ndarray, np.ndarray, np.ndarray],
                     batch: int, k: int, device: torch.device
                     ) -> Iterator[tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor, int]]:
    """The launches of _ragged_tables on `device`: (codes, starts, lens,
    offs, windows)."""
    for codes, table, n in _ragged_tables(chunks, batch, k):
        t = torch.from_numpy(table).to(device)
        starts, offs, lens = t[0], t[1], t[2].to(torch.int32)
        yield torch.from_numpy(codes).to(device), starts, lens, offs, n


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


def _launches(files: list[str], k: int, hasher: str | None, min_len: int,
              batch: int, max_len: int, device: torch.device | None
              ) -> Iterator[np.ndarray | tuple]:
    """The launches of counting, file by file: exact keys with the native
    parser as ragged launches of `batch` chunks, (codes, starts, lens, offs,
    windows) on `device`, or (codes, table, windows) on the host when
    device is None; else (batch, max_len) int8 numpy batches."""
    from .progress import Progress
    total_bytes = sum(os.path.getsize(f) for f in files
                      if os.path.exists(f)) or None
    progress = Progress(label="reads", log_every=2_500_000,
                        total_bytes=total_bytes)
    buf: list[np.ndarray] = []

    def flush():
        if buf:
            yield pack_reads(buf, batch, max_len)
            progress.update(len(buf))
            buf.clear()

    for f in files:
        chunks = _native_chunks(f, k, min_len, max_len)
        if chunks is not None:
            yield from flush()  # keep batches file-aligned on the native path
            if hasher is None:
                for launch in (_ragged_tables(chunks, batch, k)
                               if device is None else
                               _ragged_launches(chunks, batch, k, device)):
                    yield launch
                    progress.update(batch)
            else:
                for packed in _packed_batches(chunks, batch, max_len):
                    yield packed
                    progress.update(batch)
        else:
            for frag in iter_fragments([f], k, min_len, max_len):
                buf.append(frag)
                if len(buf) == batch:
                    yield from flush()
        if os.path.exists(f):
            progress.advance_bytes(os.path.getsize(f))
    yield from flush()


def _count_sharded(files: list[str], k: int, hasher: str | None,
                   min_len: int, batch: int, max_len: int, table_log2: int,
                   device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """The `sharded` engine (parallel/sharded_count.py) with the JAX
    package's geometry: this rank counts its own files, in launches of
    batch // n chunks, and steps in lockstep with the other ranks; a rank
    whose input has ended steps empty until none has input left. Every rank
    returns the whole map."""
    from .parallel.distributed import (global_mesh, initialize_distributed,
                                       local_device, shard_files_for_host)
    from .parallel.sharded_count import ShardedCounter, _all_reduce
    initialize_distributed(device=device)
    files = shard_files_for_host(files)
    _, n = global_mesh()
    device = local_device(device)
    batch = max(n, (batch // n) * n)
    per_shard = max(table_log2 - int(np.log2(n)) + 1, 12)
    counter = ShardedCounter(k, hasher, capacity_log2_per_shard=per_shard,
                             batch=batch, max_len=max_len, device=device)
    launches = _launches(files, k, hasher, min_len, batch // n, max_len,
                         device)
    while True:
        launch = next(launches, None)
        if not _all_reduce([launch is not None], device=device)[0]:
            break
        if launch is None:
            counter.add_empty(batch // n)
        elif isinstance(launch, np.ndarray):
            counter.add_codes(torch.from_numpy(launch).to(device))
        else:
            counter.add_ragged(*launch)
    return counter.items_host()


def count_kmers_device(files: Iterable[str], k: int, hasher: str | None = None,
                       min_len: int = 0, batch: int = DEFAULT_BATCH,
                       max_len: int = DEFAULT_LEN, table_log2: int = 20,
                       engine: str | None = None, *,
                       device: torch.device) -> KmerMap:
    """Count canonical k-mers of all reads into a KmerMap on `device`;
    hasher None keys exactly, 'poly' or 'fnv1a' by hash.

    engine: 'sort' (the default; append buffer + sorted store,
    ops/sortcount.StreamCounter, consolidating by its 'auto' mode), 'chunk'
    (the same with one extraction call per chunk of batches,
    ops/sortcount.ChunkedStreamCounter), 'merge' (per-launch sorted runs +
    bitonic-merge consolidation, ops/mergecount.py), 'hash'
    (open-addressing table, ops/hashtable.py) or 'sharded' (one table shard
    per rank of a torch.distributed group, parallel/sharded_count.py). All
    give the same map. Ingestion uses the native (C++) parser per file
    when available (ragged rows for exact keys, packed batches for hashed
    ones), else the Python per-fragment readers."""
    engine = engine or os.environ.get("MC_COUNT_ENGINE", "sort")
    if engine not in ("sort", "merge", "chunk", "hash", "sharded"):
        raise ValueError(f"unknown counting engine {engine!r}")
    if batch == DEFAULT_BATCH and os.environ.get("MC_COUNT_BATCH"):
        batch = max(int(os.environ["MC_COUNT_BATCH"]), 64)
    if max_len == DEFAULT_LEN and os.environ.get("MC_COUNT_MAX_LEN"):
        # any L >= k is correct (long fragments chunk with k-1 overlap);
        # clamp to k so a value left over from a smaller-k run can never
        # produce windowless batches
        max_len = max(int(os.environ["MC_COUNT_MAX_LEN"]), k, 64)
    files = [str(f) for f in files]
    if engine == "sharded":
        keys, counts = _count_sharded(files, k, hasher, min_len, batch,
                                      max_len, table_log2, device)
    else:
        keys, counts = _count_local(files, k, hasher, min_len, batch,
                                    max_len, table_log2, engine, device)
    logger.debug("k-mers HM size = %d", len(keys))
    return KmerMap(keys, counts)


def _count_local(files: list[str], k: int, hasher: str | None, min_len: int,
                 batch: int, max_len: int, table_log2: int, engine: str,
                 device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """The one-device engines, with the JAX package's geometry
    (metacherchant_tpu/counting.py:174-203): 'hash', 'merge', 'chunk', else
    'sort'. The chunk engine takes its launches on the host and groups them
    there; the others take each on `device`."""
    if engine == "hash":
        table = DeviceHashTable(device, capacity_log2=table_log2)
        add_codes, add_ragged = table.count_insert_codes, table.count_insert
        finish = table.items_host
    else:
        if engine == "merge":
            counter = MergeCounter(
                device, run_cap_log2=int(np.ceil(np.log2(batch * max_len))),
                store_cap_log2=table_log2)
        else:
            caps = dict(zip(("buffer_cap", "store_cap"),
                            _sort_geometry(table_log2, batch, max_len)))
            counter = (ChunkedStreamCounter(batch, max_len, device, **caps)
                       if engine == "chunk" else
                       StreamCounter(device, **caps))
        add_codes, add_ragged = counter.add_codes, counter.add_ragged
        finish = counter.finalize
    on_host = engine == "chunk"
    for launch in _launches(files, k, hasher, min_len, batch, max_len,
                            None if on_host else device):
        if isinstance(launch, np.ndarray):
            add_codes(launch if on_host else
                      torch.from_numpy(launch).to(device), k, hasher)
        else:
            add_ragged(*launch, k)
    return finish()


def count_kmers(files: Iterable[str], k: int, hasher: str | None = None,
                min_len: int = 0, *, device: torch.device) -> KmerMap:
    """The tools' counting: count_kmers_host when the user sets
    MC_HOST_COUNT (any non-empty value, read on every call, as the JAX
    tools read it), else count_kmers_device on `device`."""
    if os.environ.get("MC_HOST_COUNT"):
        return count_kmers_host(files, k, hasher, min_len)
    return count_kmers_device(files, k, hasher, min_len, device=device)


def count_kmers_host(files: Iterable[str], k: int, hasher: str | None = None,
                     min_len: int = 0) -> KmerMap:
    """Pure-host oracle counter (slow; tests and tiny inputs).

    Mirrors ShortKmer.kmersOf + addAndBound exactly (src/io/IOUtils.java:200-214).
    """
    counts: dict[int, int] = {}
    for f in files:
        for frag in iter_reads_split(str(f)):
            if len(frag) < max(min_len, k):
                continue
            _count_codes_into(counts, frag, k, hasher)
    return KmerMap.from_dict(counts)


def _count_codes_into(counts: dict[int, int], codes: np.ndarray, k: int,
                      hasher: str | None) -> None:
    if hasher is not None:
        wins = np.lib.stride_tricks.sliding_window_view(codes, k)
        for key in hash_codes_np(wins, hasher).tolist():
            counts[key] = counts.get(key, 0) + 1
        return
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


def load_present_kmer_strings(files: Iterable[str], k: int, hasher: str,
                              kmap: KmerMap, min_len: int = 0,
                              rows_per_batch: int = 1 << 20) -> dict[str, int]:
    """LargeKmerLoader equivalent (src/io/LargeKmerLoader.java:47-76): in the
    hashed regime map keys cannot be decoded back to strings, so re-stream the
    reads and materialize normalized-string -> count for every k-window whose
    canonical hash is present in kmap.

    Hashing is the host's vectorized hash_codes_np (exact Java wrap) over
    ~1M-window blocks; presence is one probe-table lookup per block.
    """
    from .dna import CODE_TO_CHAR
    from .algo.environment_hashed import _normalize_rows

    out: dict[str, int] = {}
    buf: list[np.ndarray] = []
    buffered = 0

    def flush():
        nonlocal buffered
        if not buf:
            return
        rows = np.concatenate(buf, axis=0)
        buf.clear()
        buffered = 0
        counts = kmap.get_many(hash_codes_np(rows, hasher))
        present = counts >= 0
        if not present.any():
            return
        rows, counts = rows[present], counts[present]
        norm = _normalize_rows(rows)
        chars = CODE_TO_CHAR[norm.astype(np.int64)]
        # dedup within the block before the python dict loop
        uniq, idx = np.unique(chars, axis=0, return_index=True)
        for row, c in zip(uniq, counts[idx]):
            out[row.tobytes().decode("ascii")] = int(c)

    for frag in iter_fragments(files, k, min_len, max_len=1 << 30):
        wins = np.lib.stride_tricks.sliding_window_view(
            np.asarray(frag, np.uint8), k)
        buf.append(wins)
        buffered += wins.shape[0]
        if buffered >= rows_per_batch:
            flush()
    flush()
    return out


def seed_keys_of_sequence(seq: str, k: int, hasher: str | None) -> np.ndarray:
    """Canonical keys of every k-window of a sequence, in order (host)."""
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, np.int64)
    if hasher is not None:
        return hash_codes_np(
            np.lib.stride_tricks.sliding_window_view(encode(seq), k), hasher)
    out = np.empty(n, np.int64)
    code = kmer_to_code(seq[:k])
    out[0] = canonical_code(code, k)
    mask = (1 << (2 * k)) - 1
    for i in range(1, n):
        code = ((code << 2) | int(CHAR_TO_CODE[ord(seq[i + k - 1])])) & mask
        out[i] = canonical_code(code, k)
    return out
