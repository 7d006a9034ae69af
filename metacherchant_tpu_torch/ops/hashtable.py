"""Open-addressing k-mer count table on the torch device (B11).

Counterpart of metacherchant_tpu/ops/hashtable.py, an XLA op in the JAX
package (no Pallas kernel), so plain torch here. It replaces the reference's
striped concurrent hash map (itmo:structures/map/BigLong2ShortHashMap.java
:62-253, itmo:structures/map/Long2ShortHashMap.java:76-157): canonical k-mer
key -> count. A whole batch of unique keys goes in per step by vectorized
linear-probe rounds:

  round: gather the table keys at the probe slots; matched keys add their
  counts; keys that find an EMPTY slot all scatter their key there and read
  the slot back -- the one lane that sees its own key wins the slot (a
  single-word store: with duplicate indices one whole value lands), losers
  advance to the next slot (linear probing), repeat.

Each round works on the lanes still active only, and torch reads their
number back (one host sync per round), so the table knows its exact size at
all times and grows before an insert could pass max_load (doubling and
re-inserting, as the JAX table does). A lane that is still active after
MAX_PROBE_ROUNDS raises: the table never drops a key silently.

Which lane wins a slot is implementation-defined, so two tables with the
same content may lay it out differently (ROADMAP C4): compare items_host,
never slots.

Semantics kept from the reference:
- counts saturate at Short.MAX_VALUE = 32767 (itmo:utils/NumUtils.java
  :21-26): int32 sums, clamped on read;
- lookup of an absent key returns -1 (Long2ShortHashMap.get:159-175), and
  so does SENTINEL, the EMPTY marker (int64 max: never an exact 2-bit key,
  and a hashed key only with probability 2^-64, as in the JAX package).

torch has no uint64 shift on the CPU (ROADMAP C1): _mix64 is int64 with
masked logical shifts, bit-equal to the JAX uint64 finalizer.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kmer_map import SATURATION
from .extract_cuda import extract_append_ragged
from .kmers import SENTINEL, _i64, canonical_kmers

EMPTY = SENTINEL
#: The JAX package bounds the probe rounds at 128 (hashtable.py:63), which
#: its 0.65 load does not keep at the exact slice's size: near that load a
#: few of 21.56M random keys land more than 128 slots from home
#: (chip_smoke.py's device-bfs phase measures it). Rounds run only while
#: lanes are left, so the higher bound costs nothing unless a key needs it.
MAX_PROBE_ROUNDS = 1024


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (the JAX package's uint64 _mix64) on int64 bits;
    products wrap mod 2^64 as uint64 ones do."""
    x = (x ^ _srl(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _srl(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _srl(x, 31)


def _probe_claim(tkeys: torch.Tensor, bkeys: torch.Tensor, max_rounds: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Find or claim a slot of the linear-probe key array `tkeys` for every
    key of `bkeys` (unique; EMPTY lanes skip). Claims write tkeys in place.

    Returns (slot (N,) int64: where the key is or landed, -1 for skipped and
    residual lanes; won (N,) bool: the key was newly inserted; residual:
    the indices of lanes that found no slot within max_rounds)."""
    C = tkeys.numel()
    slot_of = torch.full_like(bkeys, -1)
    won = torch.zeros_like(bkeys, dtype=torch.bool)
    lane = torch.nonzero(bkeys != EMPTY).squeeze(1)
    key = bkeys[lane]
    slot = _mix64(key) & (C - 1)
    for _ in range(max_rounds):
        if lane.numel() == 0:
            break
        cur = tkeys[slot]
        match = cur == key
        empty = cur == EMPTY
        tkeys[slot[empty]] = key[empty]
        win = empty & (tkeys[slot] == key)
        done = match | win
        slot_of[lane[done]] = slot[done]
        won[lane[win]] = True
        keep = ~done
        lane, key, slot = lane[keep], key[keep], (slot[keep] + 1) & (C - 1)
    return slot_of, won, lane


def _probe_find(tkeys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N,) int64 slot of each query in the linear-probe key array, -1 when
    absent; EMPTY (SENTINEL) queries are absent."""
    C = tkeys.numel()
    slot_of = torch.full_like(q, -1)
    lane = torch.nonzero(q != EMPTY).squeeze(1)
    key = q[lane]
    slot = _mix64(key) & (C - 1)
    for _ in range(C):
        if lane.numel() == 0:
            break
        cur = tkeys[slot]
        hit = cur == key
        slot_of[lane[hit]] = slot[hit]
        keep = ~(hit | (cur == EMPTY))
        lane, key, slot = lane[keep], key[keep], (slot[keep] + 1) & (C - 1)
    return slot_of


def _insert_unique(tkeys: torch.Tensor, tcnts: torch.Tensor,
                   bkeys: torch.Tensor, bcnts: torch.Tensor
                   ) -> tuple[int, torch.Tensor]:
    """Insert a batch of UNIQUE keys (EMPTY lanes skip) with int32 counts,
    in place. Returns (number of new keys, indices of residual lanes: keys
    that did not land within MAX_PROBE_ROUNDS)."""
    slot, won, residual = _probe_claim(tkeys, bkeys, MAX_PROBE_ROUNDS)
    hit = slot >= 0
    tcnts.index_add_(0, slot[hit], bcnts[hit].to(tcnts.dtype))
    return int(won.sum()), residual


def _lookup(tkeys: torch.Tensor, tcnts: torch.Tensor, q: torch.Tensor
            ) -> torch.Tensor:
    """int32 count of each query key, clamped at 32767; -1 for absent and
    SENTINEL queries (Long2ShortHashMap.get:159-175)."""
    slot = _probe_find(tkeys, q)
    hit = slot >= 0
    res = torch.full(q.shape, -1, dtype=torch.int32, device=q.device)
    res[hit] = tcnts[slot[hit]].clamp_max(SATURATION).to(torch.int32)
    return res


def _batch_unique(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort + run-length encode a flat key batch: the distinct keys other
    than SENTINEL, ascending, and their int32 multiplicities."""
    s = torch.sort(keys).values
    s = s[s != SENTINEL]
    ukeys, counts = torch.unique_consecutive(s, return_counts=True)
    return ukeys, counts.to(torch.int32)


def _raise_residual(residual: torch.Tensor) -> None:
    if residual.numel():
        raise RuntimeError(f"hash table: {residual.numel()} keys found no slot "
                           f"within {MAX_PROBE_ROUNDS} probe rounds")


class DeviceHashTable:
    """Key -> count map in two device arrays (int64 keys, int32 counts) of a
    power-of-two capacity, with exact size bookkeeping and growth."""

    def __init__(self, device: torch.device, capacity_log2: int = 16,
                 max_load: float = 0.65):
        self.device = torch.device(device)
        self.capacity = 1 << capacity_log2
        self.max_load = max_load
        self.tkeys = torch.full((self.capacity,), EMPTY, dtype=torch.int64,
                                device=self.device)
        self.tcnts = torch.zeros(self.capacity, dtype=torch.int32,
                                 device=self.device)
        self._size = 0          # live keys, kept exact by every insert

    @property
    def size(self) -> int:
        """Exact live-entry count: the table's live slots, counted on its
        device (one sync)."""
        return int((self.tkeys != EMPTY).sum())

    @classmethod
    def from_kmer_map(cls, kmap, device: torch.device) -> "DeviceHashTable":
        """One-shot build of a read-only table from a KmerMap at load 0.25
        (probe rounds are the probe BFS's layer cost)."""
        n = max(len(kmap), 1)
        table = cls(device, capacity_log2=max(
            int(np.ceil(np.log2(n / 0.25 + 1))), 4))
        keys, counts = kmap.device_arrays(table.device)
        table._insert(keys, counts)
        return table

    def _insert(self, ukeys: torch.Tensor, ucnts: torch.Tensor) -> None:
        new, residual = _insert_unique(self.tkeys, self.tcnts, ukeys, ucnts)
        _raise_residual(residual)
        self._size += new

    def _ensure_room(self, incoming: int) -> None:
        while self._size + incoming > self.capacity * self.max_load:
            self._grow()

    def _grow(self) -> None:
        """Double the capacity and re-insert the live entries."""
        live = self.tkeys != EMPTY
        keys, cnts = self.tkeys[live], self.tcnts[live]
        self.capacity *= 2
        self.tkeys = torch.full((self.capacity,), EMPTY, dtype=torch.int64,
                                device=self.device)
        self.tcnts = torch.zeros(self.capacity, dtype=torch.int32,
                                 device=self.device)
        self._size = 0
        self._insert(keys, cnts)

    # -- counting -----------------------------------------------------------
    def insert_batch(self, keys: torch.Tensor) -> None:
        """Count-insert a key batch (duplicates and SENTINEL lanes allowed)."""
        ukeys, ucnts = _batch_unique(keys.reshape(-1))
        self._ensure_room(ukeys.numel())
        self._insert(ukeys, ucnts)

    def count_insert_codes(self, codes: torch.Tensor, k: int,
                           hasher: str | None) -> None:
        """Count the canonical k-mers of a (B, L) code batch (-1 padded)."""
        keys, _ = canonical_kmers(codes, k, hasher)
        self.insert_batch(keys)

    def count_insert(self, codes: torch.Tensor, starts: torch.Tensor,
                     lens: torch.Tensor, offs: torch.Tensor, n: int,
                     k: int) -> None:
        """Count the exact keys of ragged rows, `n` windows in all (B1's
        ragged entry, ops/extract_cuda.extract_append_ragged, writes them
        into a flat buffer, no SENTINEL)."""
        buf = torch.empty(n, dtype=torch.int64, device=self.device)
        extract_append_ragged(codes, starts, lens, offs, k, buf)
        self.insert_batch(buf)

    def lookup(self, keys: torch.Tensor) -> torch.Tensor:
        """int32 counts of `keys`; absent and SENTINEL -> -1; clamped at
        32767."""
        return _lookup(self.tkeys, self.tcnts, keys)

    # -- extraction ---------------------------------------------------------
    def items_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The live (keys, counts), key-sorted, on the device (counts not
        clamped)."""
        live = self.tkeys != EMPTY
        keys, order = torch.sort(self.tkeys[live])
        return keys, self.tcnts[live][order]

    def items_host(self) -> tuple[np.ndarray, np.ndarray]:
        """All (key, count) pairs, key-sorted, counts clamped at 32767."""
        keys, cnts = self.items_device()
        return (keys.cpu().numpy(),
                cnts.clamp_max(SATURATION).cpu().numpy())
