"""Sort-based streaming k-mer counter (the `sort` counting engine), in torch.

Counterpart of metacherchant_tpu/ops/sortcount.py::StreamCounter:

  append:       extract canonical keys of a (B, L) code batch, drop the
                first k-1 columns and write the rest flat at buf[offset:]
                (append_codes; the CUDA kernel of ops/extract_cuda.py on a
                GPU, its plain torch version on the CPU)
  consolidate:  when the buffer is full, merge it into the sorted (key,
                count) store: one sort of store + buffer, an int64 cumsum of
                the weights, the run-last lanes kept by a boolean mask, and
                counts as the adjacent differences of their cumsums
  finalize:     last consolidation; counts clamp at 32767
                (itmo:utils/NumUtils.java:21-26)

The result equals the JAX package's split consolidation
(_consolidate_full_split) for the same batches. The JAX engine defers the
store-size readback to the next consolidation; here each consolidation reads
it at once (the boolean-mask compaction synchronises anyway), so the store is
always compact: its keys sorted, no SENTINEL padding. store_cap and
buffer_cap follow the JAX growth policy (_resolve), which keeps buffer +
store at a power of two.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kmer_map import SATURATION
from .extract_cuda import extract_append
from .kmers import SENTINEL

#: store counts clamp far above the 32767 output saturation, so repeated
#: consolidations cannot overflow int32 yet keep min(total, 32767)
_COUNT_CLAMP = 1_000_000_000


def append_codes(buf: torch.Tensor, offset: int, codes: torch.Tensor,
                 k: int) -> int:
    """Append the keys of a (B, L) int8 code batch at buf[offset:] (the
    first k-1 key columns of every row never hold a window and are dropped).
    Returns the new offset. Raises where the JAX append would clamp."""
    n = codes.shape[0] * (codes.shape[1] - k + 1)
    if offset + n > buf.numel():
        raise ValueError(f"append of {n} keys at offset {offset} overflows "
                         f"the {buf.numel()}-lane buffer")
    extract_append(codes, k, buf[offset:offset + n])
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


class StreamCounter:
    """Device streaming counter: append buffer + compact sorted store."""

    def __init__(self, device: torch.device, buffer_cap: int = 1 << 24,
                 store_cap: int = 1 << 22):
        self.device = torch.device(device)
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

    def add_codes(self, codes: torch.Tensor, k: int) -> None:
        width = codes.shape[1] - k + 1  # first k-1 key columns are trimmed
        if width <= 0:
            return  # no window fits: nothing to count
        if self.offset + codes.shape[0] * width > self.buffer_cap:
            self._consolidate()
        self.offset = append_codes(self.buf, self.offset, codes, k)

    def _grow(self, live: int) -> None:
        """Store growth as metacherchant_tpu's StreamCounter._resolve: double
        the store until it holds `live` keys; when it grew, realign buffer +
        store to the power of two that holds the old total and twice the
        store; the buffer never shrinks below the store."""
        old_total = self.buffer_cap + self.store_cap
        if live > self.store_cap:
            while live > self.store_cap:
                self.store_cap *= 2
            total = 1 << int(np.ceil(np.log2(max(old_total,
                                                 2 * self.store_cap))))
            self.buffer_cap = total - self.store_cap
        self.buffer_cap = max(self.buffer_cap, self.store_cap)

    def _consolidate(self) -> None:
        if self.offset == 0:
            return
        self.store_keys, self.store_cnts = consolidate(
            self.store_keys, self.store_cnts, self.buf[:self.offset])
        self.offset = 0
        self._grow(self.store_keys.numel())
        if self.buf.numel() != self.buffer_cap:
            self.buf = torch.empty(self.buffer_cap, dtype=torch.int64,
                                   device=self.device)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Key-sorted (keys, counts) on the host, counts clamped at 32767."""
        self._consolidate()
        keys = self.store_keys.cpu().numpy()
        cnts = self.store_cnts.clamp_max(SATURATION).cpu().numpy()
        return keys, cnts
