"""KmerMap: immutable canonical-kmer -> count map as sorted arrays.

This is the host-facing view of the counted de Bruijn graph, carried over
from metacherchant_tpu/kmer_map.py: counting (ops/sortcount.py) freezes into
sorted numpy (keys, counts) arrays, and BFS seeding and the writers query
them on the host. Both packages hold the map as numpy, so a JAX KmerMap's
(keys, counts) build an equal port KmerMap. The device lookup half is not
ported yet.

Count semantics per the reference map (itmo:structures/map/Long2ShortHashMap.java):
get() of an absent key -> -1 (:159-175), counts saturate at 32767
(itmo:utils/NumUtils.java:21-26).
"""
from __future__ import annotations

import numpy as np

SATURATION = 32767


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, numpy uint64 wrapping arithmetic."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


class KmerMap:
    def __init__(self, keys: np.ndarray, counts: np.ndarray):
        assert keys.ndim == 1 and keys.shape == counts.shape
        self.keys = np.ascontiguousarray(keys, dtype=np.int64)
        self.counts = np.ascontiguousarray(
            np.minimum(counts, SATURATION), dtype=np.int32)

    @staticmethod
    def from_pairs(keys: np.ndarray, counts: np.ndarray) -> "KmerMap":
        """Build from possibly-unsorted, possibly-duplicated pairs (counts sum)."""
        keys = np.asarray(keys, np.int64)
        counts = np.asarray(counts, np.int64)
        order = np.argsort(keys, kind="stable")
        keys, counts = keys[order], counts[order]
        if keys.size:
            first = np.concatenate([[True], keys[1:] != keys[:-1]])
            idx = np.flatnonzero(first)
            keys = keys[idx]
            counts = np.add.reduceat(counts, idx)
        return KmerMap(keys, np.minimum(counts, SATURATION))

    @staticmethod
    def from_dict(d: dict[int, int]) -> "KmerMap":
        if not d:
            return KmerMap(np.empty(0, np.int64), np.empty(0, np.int32))
        keys = np.fromiter(d.keys(), np.int64, len(d))
        counts = np.fromiter(d.values(), np.int64, len(d))
        return KmerMap.from_pairs(keys, counts)

    def __len__(self) -> int:
        return self.keys.size

    #: probe table load factor; probe rounds are linear, so keep it low
    _PROBE_LOAD = 0.35
    #: tcnts sentinel for an empty slot (real counts are >= 0; get() of an
    #: absent key returns -1, so -2 is unreachable as a stored value)
    _PROBE_EMPTY = -2

    def _probe_table(self):
        """Lazily-built host open-addressing table for bulk lookups.

        np.searchsorted costs ~290 ns/query on large maps (measured round 4:
        96% of find_reads); linear-probe rounds over a lightly-loaded table
        resolve most queries in 1-2 gathers. Slot emptiness is encoded in
        the counts array (sentinel -2) so each probe round gathers keys +
        counts only -- no key sentinel is stolen (hashed k>31 keys span the
        full int64 range)."""
        cached = getattr(self, "_ptable", None)
        if cached is not None:
            return cached
        n = self.keys.size
        cap = 1 << max(int(np.ceil(np.log2(n / self._PROBE_LOAD + 1))), 4)
        mask = np.uint64(cap - 1)
        tkeys = np.zeros(cap, np.int64)
        tcnts = np.full(cap, self._PROBE_EMPTY, np.int32)
        slot = (_mix64_np(self.keys.view(np.uint64)) & mask).astype(np.int64)
        pending = np.arange(n)
        while pending.size:
            s = slot[pending]
            free = tcnts[s] == self._PROBE_EMPTY
            cand = pending[free]
            s_cand = s[free]
            # first writer per slot wins this round (keys are unique)
            uniq_s, first_idx = np.unique(s_cand, return_index=True)
            winners = cand[first_idx]
            tkeys[uniq_s] = self.keys[winners]
            tcnts[uniq_s] = self.counts[winners]
            placed = np.zeros(n, bool)
            placed[winners] = True
            pending = pending[~placed[pending]]
            slot[pending] = (slot[pending] + 1) & np.int64(cap - 1)
        self._ptable = (tkeys, tcnts, np.int64(cap - 1))
        return self._ptable

    def get_many(self, query: np.ndarray) -> np.ndarray:
        """Vectorized count lookup; absent -> -1 (Long2ShortHashMap.get
        semantics, itmo:structures/map/Long2ShortHashMap.java:159-175)."""
        query = np.asarray(query, np.int64)
        if self.keys.size == 0:
            return np.full(query.shape, -1, np.int32)
        q = np.ascontiguousarray(query.ravel())
        tkeys, tcnts, mask = self._probe_table()
        out = np.full(q.size, -1, np.int32)
        slot = (_mix64_np(q.view(np.uint64)) & np.uint64(mask)).astype(
            np.int64)
        active = np.arange(q.size)
        for _ in range(tcnts.size):
            s = slot[active]
            c_at = tcnts[s]
            occupied = c_at != self._PROBE_EMPTY
            hit = occupied & (tkeys[s] == q[active])
            out[active[hit]] = c_at[hit]
            cont = occupied & ~hit  # occupied by someone else: keep probing
            active = active[cont]
            if active.size == 0:
                break
            slot[active] = (slot[active] + 1) & mask
        return out.reshape(query.shape)

    def oriented_dict(self, k: int) -> dict[int, int]:
        """Both orientations of every (exact-regime) canonical key -> count.

        Scalar-probe structure for the sequential FIFO BFS: one Python dict
        hit replaces per-neighbor canonicalization + vectorized searchsorted
        (which costs ~50us per 1-element call -- ruinous for the deep,
        frontier-of-1 traversals typical of gene environments). Built once
        per (map, k), cached. Exact regime only (hashed keys have no
        orientation to expand)."""
        cached = getattr(self, "_oriented", None)
        if cached is None or self._oriented_k != k:
            from .dna import revcomp_codes_np
            d = dict(zip(self.keys.tolist(), self.counts.tolist()))
            rc = revcomp_codes_np(self.keys, k)
            d.update(zip(rc.tolist(), self.counts.tolist()))
            self._oriented = d
            self._oriented_k = k
            cached = d
        return cached
