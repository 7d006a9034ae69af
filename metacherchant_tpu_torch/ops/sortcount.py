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
  consolidate:  when the buffer is full, merge it into the sorted (key,
                count) store by one of the JAX package's routes (`mode`):
                sort2 -- one sort of store + buffer, an int64 cumsum of the
                weights, the run-last lanes kept by a boolean mask, counts as
                the adjacent differences of their cumsums (consolidate); with
                MC_SORT_COMPACTION=shift at a power-of-two total, the
                run-lasts move to the front by shift stages instead
                (_consolidate_full_split); merge -- a sort of the buffer
                alone, a bitonic merge into the sorted store, the same
                cumsum and shift stages (_consolidate_merge_split)
  finalize:     last consolidation; counts clamp at 32767
                (itmo:utils/NumUtils.java:21-26)

Every route gives the JAX route's store. The JAX engine defers the
store-size readback to the next consolidation; here each consolidation
reads it at once, so the store is compact (its keys sorted, no SENTINEL
padding), while the growth it calls for is applied where JAX applies it,
at the next consolidation, so that buffer and store keep the JAX sizes
(_resolve): on padded batches both packages consolidate at the same
batches.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import trace
from ..kmer_map import SATURATION
from .bitonic import (_displacement, _half_clean, _shift_compact_stages)
from .extract_cuda import extract_append, extract_append_ragged
from .kmers import SENTINEL, hash_canonical_kmers

#: store counts clamp far above the 32767 output saturation, so repeated
#: consolidations cannot overflow int32 yet keep min(total, 32767)
_COUNT_CLAMP = 1_000_000_000


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


def consolidate(store_keys: torch.Tensor, store_cnts: torch.Tensor,
                new_keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge appended keys (SENTINEL lanes allowed) into a sorted store.

    Weights: store counts, 1 per appended lane, 0 for SENTINEL. Returns the
    new store: distinct keys ascending and int32 counts clamped at 1e9."""
    keys = torch.cat([store_keys, new_keys])
    w = torch.cat([store_cnts.to(torch.int64),
                   torch.ones_like(new_keys)])
    w.masked_fill_(keys == SENTINEL, 0)
    s, order = torch.sort(keys)
    pc = torch.cumsum(w[order], 0)
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    last &= s != SENTINEL
    out_keys = s[last]
    pref = pc[last]
    cnts = torch.diff(pref, prepend=pref.new_zeros(1))
    return out_keys, cnts.clamp_max_(_COUNT_CLAMP).to(torch.int32)


# --- the JAX package's full-length consolidations. Each takes a store of
# store_cap lanes (distinct keys ascending, SENTINEL behind) and the whole
# append buffer with its fill `offset`, and returns (keys, counts,
# n_distinct) at the full merged length, the distinct keys ascending at
# the front, (SENTINEL, 0) behind, so that nothing is lost whatever the
# store's size (metacherchant_tpu/ops/sortcount.py:195-373).

def _masked(buf: torch.Tensor, offset: int) -> torch.Tensor:
    """The buffer with every lane at or past `offset` set to SENTINEL."""
    out = buf.clone()
    out[offset:] = SENTINEL
    return out


def _full(keys: torch.Tensor, cnts: torch.Tensor, n: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A compact store as the full-length result of n lanes."""
    nd = keys.numel()
    return (torch.cat([keys, keys.new_full((n - nd,), SENTINEL)]),
            torch.cat([cnts, cnts.new_zeros(n - nd)]),
            torch.tensor(nd, dtype=torch.int32, device=keys.device))


def _shift_compaction(total: int) -> bool:
    """MC_SORT_COMPACTION=shift, which applies to power-of-two totals only
    (any other total takes the sort2 compaction); read on every call."""
    return (os.environ.get("MC_SORT_COMPACTION") == "shift"
            and total & (total - 1) == 0)


def _consolidate_full_split(store_keys: torch.Tensor,
                            store_cnts: torch.Tensor, buf: torch.Tensor,
                            offset: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The sort2 route: one sort of store + buffer, then either the
    cumsum-and-mask compaction (consolidate) or, under
    MC_SORT_COMPACTION=shift at a power-of-two total, the shift stages."""
    n = store_keys.numel() + buf.numel()
    if not _shift_compaction(n):
        keys, cnts = consolidate(store_keys, store_cnts, buf[:offset])
        return _full(keys, cnts, n)
    keys = torch.cat([store_keys, _masked(buf, offset)])
    w = torch.cat([store_cnts, torch.ones_like(buf, dtype=torch.int32)])
    w.masked_fill_(keys == SENTINEL, 0)
    s, order = torch.sort(keys)
    return _shift_compact(s, w[order])


def _shift_compact(keys: torch.Tensor, w: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-last marking and shift compaction of a sorted multiset of a
    power-of-two lane count (the merge route's tail, and the sort2 route's
    under MC_SORT_COMPACTION=shift)."""
    key2, pref2, d = _prefix_mark(keys, w)
    key2, pref2 = _shift_compact_stages(key2, pref2, d)
    return _diff_finish(key2, pref2)


def _sort_keys(buf: torch.Tensor, offset: int) -> torch.Tensor:
    """The buffer, its unfilled tail masked to SENTINEL, sorted."""
    return torch.sort(_masked(buf, offset)).values


def _merge_prep(store_keys: torch.Tensor, store_cnts: torch.Tensor,
                sorted_buf: torch.Tensor, pad: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Store ascending ++ `pad` SENTINEL lanes ++ the sorted buffer
    reversed: one bitonic sequence of a power-of-two length. Store weights
    are its counts clamped at 1e9, buffer lanes weigh 1, SENTINEL 0."""
    sw = torch.where(store_keys == SENTINEL, 0,
                     store_cnts.clamp_max(_COUNT_CLAMP)).to(torch.int32)
    bw = (sorted_buf != SENTINEL).to(torch.int32)
    keys = torch.cat([store_keys, sorted_buf.new_full((pad,), SENTINEL),
                      sorted_buf.flip(0)])
    w = torch.cat([sw, bw.new_zeros(pad), bw.flip(0)])
    return keys, w


def _prefix_mark(keys: torch.Tensor, w: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inclusive int64 cumsum of the weights kept at run-last lanes
    ((SENTINEL, 0) elsewhere), and each kept lane's displacement (the holes
    before it) for the shift compaction."""
    pc = torch.cumsum(w.to(torch.int64), 0)
    real = torch.ones_like(keys, dtype=torch.bool)
    real[:-1] = keys[1:] != keys[:-1]
    real &= keys != SENTINEL
    return (torch.where(real, keys, SENTINEL), torch.where(real, pc, 0),
            _displacement(real))


def _diff_finish(keys_c: torch.Tensor, pref_c: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counts as adjacent differences of the compacted cumsums, clamped at
    1e9; n_distinct as a 0-d int32 tensor."""
    prev = torch.cat([pref_c.new_zeros(1), pref_c[:-1]])
    sentinel = keys_c == SENTINEL
    cnts = torch.where(sentinel, 0, pref_c - prev)
    cnts = cnts.clamp_max(_COUNT_CLAMP).to(torch.int32)
    return keys_c, cnts, (~sentinel).sum(dtype=torch.int32)


def _consolidate_merge_split(store_keys: torch.Tensor,
                             store_cnts: torch.Tensor, buf: torch.Tensor,
                             offset: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The merge route: sort the buffer alone, bitonic-merge it into the
    already sorted store (the total padded to a power of two on the buffer
    side), then prefix-mark and shift-compact. The JAX package groups its
    stages four to a compiled unit; in torch each stage is its own ops
    either way, with the same lanes after every stage.

    A caller that passes its only reference to `buf` frees it before the
    stages run."""
    raw = store_keys.numel() + buf.numel()
    n = 1 << (raw - 1).bit_length()
    sorted_buf = _sort_keys(buf, offset)
    del buf
    keys, w = _merge_prep(store_keys, store_cnts, sorted_buf, n - raw)
    del sorted_buf
    stride = n // 2
    while stride >= 1:
        keys, (w,) = _half_clean(keys, [w], stride)
        stride //= 2
    return _shift_compact(keys, w)


class StreamCounter:
    """Device streaming counter: append buffer + compact sorted store.

    mode: 'sort2' (consolidate by one sort of store + buffer), 'merge' (sort
    the buffer alone and bitonic-merge it into the store) or 'auto' (merge
    above SORT2_LANE_CEILING total lanes), as the JAX StreamCounter."""

    #: the JAX package's sort2 ceiling (metacherchant_tpu/ops/sortcount.py
    #: :438-445): the widest two-operand sort its TPU compile service was
    #: measured to finish. It is a limit of that compiler, not a fact of
    #: the H100 (torch.sort has none); 'auto' keeps it so that the port
    #: consolidates where and how the JAX package does.
    SORT2_LANE_CEILING = 1 << 24

    def __init__(self, device: torch.device, buffer_cap: int = 1 << 24,
                 store_cap: int = 1 << 22, mode: str = "auto"):
        if mode not in ("auto", "sort2", "merge"):
            raise ValueError(
                f"mode must be 'auto', 'sort2' or 'merge'; got {mode!r}")
        self.device = torch.device(device)
        self.mode = mode
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

    def uses_merge(self) -> bool:
        """Whether the next consolidation takes the merge route: JAX's
        total is its padded store plus the whole buffer."""
        total = self.store_cap + self.buf.numel()
        return self.mode == "merge" or (
            self.mode == "auto" and total > self.SORT2_LANE_CEILING)

    def _padded_store(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The store as the JAX engine holds it: store_cap lanes."""
        pad = self.store_cap - self.store_keys.numel()
        return (torch.cat([self.store_keys,
                           self.store_keys.new_full((pad,), SENTINEL)]),
                torch.cat([self.store_cnts, self.store_cnts.new_zeros(pad)]))

    def _take_buffer(self) -> torch.Tensor:
        buf, self.buf = self.buf, None
        return buf

    def _consolidate(self) -> None:
        if self.offset == 0:
            return
        self._resolve()
        use_merge = self.uses_merge()
        shift = _shift_compaction(self.store_cap + self.buf.numel())
        with trace.span("count.consolidate",
                        route=("merge_split" if use_merge else
                               "full_split" if shift else "sort2"),
                        store_in=self.store_keys.numel(),
                        lanes=self.offset) as sp:
            if use_merge or shift:
                fn = (_consolidate_merge_split if use_merge
                      else _consolidate_full_split)
                # the buffer goes in as the only reference: the merge route
                # frees it before its stages run
                keys, cnts, nd = fn(*self._padded_store(),
                                    self._take_buffer(), self.offset)
                nd = int(nd)
                self.store_keys, self.store_cnts = (keys[:nd].clone(),
                                                    cnts[:nd].clone())
            else:
                self.store_keys, self.store_cnts = consolidate(
                    self.store_keys, self.store_cnts, self.buf[:self.offset])
            sp.set(store_out=self.store_keys.numel())
        self.offset = 0
        # keep buffer >= store so merge-route padding stays bounded
        self.buffer_cap = max(self.buffer_cap, self.store_cap)
        if self.buf is None or self.buf.numel() != self.buffer_cap:
            self.buf = None  # the old buffer goes before the new one comes
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
