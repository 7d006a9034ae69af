"""Sort-based streaming k-mer counters (the `sort` and `chunk` counting
engines), in torch.

Counterpart of metacherchant_tpu/ops/sortcount.py::StreamCounter and
ChunkedStreamCounter:

  append:       extract canonical keys of a (B, L) code batch, drop the
                first k-1 columns and write the rest flat at buf[offset:]
                (append_codes; exact keys through the CUDA kernel of
                ops/extract_cuda.py on a GPU and its plain torch version on
                the CPU, hashed keys through ops/kmers.hash_canonical_kmers);
                or write the exact keys of ragged rows of a flat code array,
                every window of every row and nothing else (append_ragged,
                the same kernel's ragged entry)
  consolidate:  when the buffer is full, merge its filled lanes into the
                sorted (key, count) store (ops/consolidate_cuda
                .merge_into_store: on the card a sort of the lanes and one
                merge-path kernel, on the CPU the plain sort-and-reduce,
                consolidate)
  finalize:     last consolidation; counts clamp at 32767
                (itmo:utils/NumUtils.java:21-26)

The store is the JAX StreamCounter's under each of its consolidation routes
(its `mode` and its compaction switch, which pick among routes its TPU
compiler needs and change no output, have no counterpart here). The JAX
engine defers the store-size readback to the next consolidation; here each
consolidation reads it at once, so the store is compact (its keys sorted,
no SENTINEL padding), while the growth it calls for is applied where JAX
applies it, at the next consolidation, so that buffer and store keep the
JAX sizes (_resolve): on padded batches both packages consolidate at the
same batches.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..kmer_map import SATURATION
from . import consolidate_cuda
# consolidate is also this module's for parallel/sharded_count.py
from .consolidate_cuda import consolidate, merge_into_store
from .extract_cuda import extract_append, extract_append_ragged
from .kmers import SENTINEL, hash_canonical_kmers


def append_codes(buf: torch.Tensor, offset: int, codes: torch.Tensor,
                 k: int, hasher: str | None = None) -> int:
    """Append the keys of a (B, L) int8 code batch at buf[offset:] (the
    first k-1 key columns of every row never hold a window and are dropped).
    Returns the new offset. Raises where the JAX append would clamp."""
    n = codes.shape[0] * (codes.shape[1] - k + 1)
    if offset + n > buf.numel():
        raise ValueError(f"append of {n} keys at offset {offset} overflows "
                         f"the {buf.numel()}-lane buffer")
    if hasher is None:
        extract_append(codes, k, buf[offset:offset + n])
    else:
        keys, _ = hash_canonical_kmers(codes, k, hasher)
        buf[offset:offset + n] = keys[:, k - 1:].reshape(-1)
    return offset + n


def append_ragged(buf: torch.Tensor, offset: int, codes: torch.Tensor,
                  starts: torch.Tensor, lens: torch.Tensor, offs: torch.Tensor,
                  n: int, k: int) -> int:
    """Append the exact keys of ragged rows (ops/extract_cuda
    .extract_append_ragged; `n` is their window count, sum(lens - k + 1))
    at buf[offset:]. Returns the new offset. Raises where the JAX append
    would clamp."""
    if offset + n > buf.numel():
        raise ValueError(f"append of {n} keys at offset {offset} overflows "
                         f"the {buf.numel()}-lane buffer")
    extract_append_ragged(codes, starts, lens, offs, k,
                          buf[offset:offset + n])
    return offset + n


class StreamCounter:
    """Device streaming counter: append buffer + compact sorted store; every
    consolidation is merge_into_store."""

    def __init__(self, device: torch.device, buffer_cap: int = 1 << 24,
                 store_cap: int = 1 << 22):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the merge kernel is built and loaded with the counter, not in
            # the first consolidation of a run
            consolidate_cuda.load()
        self.buffer_cap = buffer_cap
        self.store_cap = store_cap
        self.buf = torch.empty(buffer_cap, dtype=torch.int64,
                               device=self.device)
        self.offset = 0
        self.store_keys = torch.empty(0, dtype=torch.int64, device=self.device)
        self.store_cnts = torch.empty(0, dtype=torch.int32, device=self.device)

    @classmethod
    def from_state(cls, store_keys: np.ndarray, store_cnts: np.ndarray,
                   device: torch.device, **caps) -> "StreamCounter":
        """Start from a store another counter reached, e.g. a JAX
        StreamCounter's (np.asarray(sc.store_keys), np.asarray(sc.store_cnts))
        after its last consolidation: distinct keys ascending at the front,
        SENTINEL padding behind. store_cap defaults to the store's length."""
        keys = np.asarray(store_keys, np.int64)
        live = int(np.count_nonzero(keys != SENTINEL))
        if not (np.all(keys[live:] == SENTINEL)
                and np.all(np.diff(keys[:live]) > 0)):
            raise ValueError("store keys must be distinct, ascending and "
                             "SENTINEL-padded")
        caps.setdefault("store_cap", max(keys.size, 1))
        sc = cls(device, **caps)
        if live > sc.store_cap:
            raise ValueError(f"{live} live keys exceed store_cap "
                             f"{sc.store_cap}")
        sc.store_keys = torch.from_numpy(keys[:live].copy()).to(sc.device)
        sc.store_cnts = torch.from_numpy(
            np.asarray(store_cnts, np.int32)[:live].copy()).to(sc.device)
        return sc

    def add_codes(self, codes: torch.Tensor, k: int,
                  hasher: str | None = None) -> None:
        width = codes.shape[1] - k + 1  # first k-1 key columns are trimmed
        if width <= 0:
            return  # no window fits: nothing to count
        if self.offset + codes.shape[0] * width > self.buffer_cap:
            self._consolidate()
        self.offset = append_codes(self.buf, self.offset, codes, k, hasher)

    def add_ragged(self, codes: torch.Tensor, starts: torch.Tensor,
                   lens: torch.Tensor, offs: torch.Tensor, n: int,
                   k: int) -> None:
        """Exact keys of ragged rows (append_ragged), `n` windows in all."""
        if self.offset + n > self.buffer_cap:
            self._consolidate()
        self.offset = append_ragged(self.buf, self.offset, codes, starts,
                                    lens, offs, n, k)

    def _resolve(self) -> None:
        """Store growth as the JAX StreamCounter._resolve, for the store
        the last consolidation left: double the store until it holds it;
        when it grew, realign buffer + store to the power of two that holds
        the old total and twice the store."""
        live = self.store_keys.numel()
        if live <= self.store_cap:
            return
        old_total = self.buffer_cap + self.store_cap
        while live > self.store_cap:
            self.store_cap *= 2
        total = 1 << int(np.ceil(np.log2(max(old_total,
                                             2 * self.store_cap))))
        self.buffer_cap = total - self.store_cap

    def _take_buffer(self) -> torch.Tensor:
        buf, self.buf = self.buf, None
        return buf

    def _consolidate(self) -> None:
        if self.offset == 0:
            return
        self._resolve()
        with trace.span("count.consolidate",
                        store_in=self.store_keys.numel(),
                        lanes=self.offset) as sp:
            # the buffer goes in as the only reference: on the card it is
            # freed once its filled lanes are sorted
            self.store_keys, self.store_cnts = merge_into_store(
                self.store_keys, self.store_cnts, self._take_buffer(),
                self.offset, self.store_cap)
            sp.set(store_out=self.store_keys.numel())
        self.offset = 0
        # buffer >= store, as the JAX engine keeps it (which bounds its
        # merge route's padding)
        self.buffer_cap = max(self.buffer_cap, self.store_cap)
        self.buf = torch.empty(self.buffer_cap, dtype=torch.int64,
                               device=self.device)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Key-sorted (keys, counts) on the host, counts clamped at 32767."""
        self._consolidate()
        self._resolve()
        keys = self.store_keys.cpu().numpy()
        cnts = self.store_cnts.clamp_max(SATURATION).cpu().numpy()
        return keys, cnts


class ChunkedStreamCounter:
    """StreamCounter with one extraction call per chunk of batches
    (MC_COUNT_ENGINE=chunk).

    Counterpart of metacherchant_tpu/ops/sortcount.py::ChunkedStreamCounter:
    the host groups batches, and consolidation, growth and finalize are the
    wrapped StreamCounter's.

    - Padded (B, L) batches (hashed keys, the Python readers): as JAX, every
      `chunk_batches` batches (or at finalize) go to the device as one
      (NB·B, L) array, the last partial chunk padded with -1 rows (whose
      SENTINEL lanes consolidation drops), and take one append_codes call:
      one kernel launch for exact keys, one B3 call for hashed ones. The
      default chunk fills the buffer once; a consolidation that shrinks the
      buffer re-fits it.
    - Ragged launches (exact keys with the native parser, add_ragged): the
      host concatenates the code slices and rebased chunk tables of as many
      launches as fit the buffer's free lanes into one extract_append_ragged
      launch; it consolidates when the next launch does not fit, as the
      sort engine does, so both consolidate at the same launches.
      `chunk_batches`, when given, caps the launches per chunk.
    """

    def __init__(self, batch: int, max_len: int, device: torch.device,
                 chunk_batches: int | None = None, **stream_kw):
        self.sc = StreamCounter(device, **stream_kw)
        self.batch = batch
        self.max_len = max_len
        self._explicit_chunk = chunk_batches
        self.chunk_batches = chunk_batches or 1  # re-fit once k is known
        self._pending: list[np.ndarray] = []
        self._ragged: list[tuple[np.ndarray, np.ndarray, int]] = []
        self._ragged_n = 0
        self._k: int | None = None
        self._hasher: str | None = None

    def _per_batch(self) -> int:
        # appended lanes per batch after the k-1 column trim
        return self.batch * max(self.max_len - self._k + 1, 0)

    def add_codes(self, codes: np.ndarray, k: int,
                  hasher: str | None = None) -> None:
        """A (B, L) code batch on the host."""
        self._flush_ragged()
        if self._k is None:
            self._k = k
            if self._explicit_chunk is None:
                self.chunk_batches = max(
                    self.sc.buffer_cap // max(self._per_batch(), 1), 1)
        self._k, self._hasher = k, hasher
        self._pending.append(np.asarray(codes, np.int8))
        if len(self._pending) >= self.chunk_batches:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return  # nothing ever added: _k may still be None
        sc = self.sc
        per_batch = self._per_batch()
        if per_batch <= 0:
            self._pending.clear()
            return
        while self._pending:
            incoming = self.chunk_batches * per_batch
            if sc.offset + incoming > sc.buffer_cap:
                sc._consolidate()
            # ORDER MATTERS: the consolidation can shrink the buffer (store
            # growth realigns buffer + store), so the chunk is re-fit after
            # it; sized before, the chunk's append could overflow the new
            # buffer
            if incoming > sc.buffer_cap:
                if per_batch > sc.buffer_cap:
                    raise ValueError(
                        f"one batch ({per_batch} keys) exceeds the append "
                        f"buffer ({sc.buffer_cap} lanes)")
                self.chunk_batches = max(sc.buffer_cap // per_batch, 1)
            nb = self.chunk_batches
            group, self._pending = self._pending[:nb], self._pending[nb:]
            chunk = np.full((nb * self.batch, self.max_len), -1, np.int8)
            for i, b in enumerate(group):
                chunk[i * self.batch:i * self.batch + b.shape[0],
                      :b.shape[1]] = b
            with trace.span("count.launch", windows=nb * per_batch,
                            h2d_bytes=chunk.nbytes):
                sc.offset = append_codes(
                    sc.buf, sc.offset, torch.from_numpy(chunk).to(sc.device),
                    self._k, self._hasher)

    def add_ragged(self, codes: np.ndarray, table: np.ndarray, n: int,
                   k: int) -> None:
        """One launch's ragged rows on the host: a code slice, its table
        (starts, offs, lens) and its window count `n`."""
        self._flush()
        sc = self.sc
        if self._ragged and sc.offset + self._ragged_n + n > sc.buffer_cap:
            self._flush_ragged()
        if not self._ragged and sc.offset + n > sc.buffer_cap:
            sc._consolidate()
            if n > sc.buffer_cap:
                raise ValueError(f"one batch ({n} keys) exceeds the append "
                                 f"buffer ({sc.buffer_cap} lanes)")
        self._k = k
        self._ragged.append((codes, table, n))
        self._ragged_n += n
        if self._explicit_chunk and len(self._ragged) >= self._explicit_chunk:
            self._flush_ragged()

    def _flush_ragged(self) -> None:
        """The pending ragged launches as one launch of the kernel."""
        if not self._ragged:
            return
        group, n = self._ragged, self._ragged_n
        self._ragged, self._ragged_n = [], 0
        code_base = np.cumsum([0] + [c.size for c, _, _ in group[:-1]])
        key_base = np.cumsum([0] + [m for _, _, m in group[:-1]])
        table = np.concatenate(
            [t + np.array([[cb], [kb], [0]]) for (_, t, _), cb, kb
             in zip(group, code_base, key_base)], axis=1)
        dev = self.sc.device
        codes = np.concatenate([c for c, _, _ in group])
        nbytes = table.nbytes + codes.nbytes
        with trace.span("count.launch", windows=n, h2d_bytes=nbytes):
            t = torch.from_numpy(table).to(dev)
            self.sc.offset = append_ragged(
                self.sc.buf, self.sc.offset, torch.from_numpy(codes).to(dev),
                t[0], t[2].to(torch.int32), t[1], n, self._k)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        self._flush()
        self._flush_ragged()
        return self.sc.finalize()
