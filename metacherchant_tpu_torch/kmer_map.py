"""KmerMap: immutable canonical-kmer -> count map as sorted arrays.

This is the host-facing view of the counted de Bruijn graph, carried over
from metacherchant_tpu/kmer_map.py: counting (ops/sortcount.py) freezes into
sorted numpy (keys, counts) arrays, and BFS seeding, the classifier and the
writers query them on the host. Both packages hold the map as numpy, so a
JAX KmerMap's (keys, counts) build an equal port KmerMap. The device half is
a copy of the sorted arrays on a torch device, probed by torch.searchsorted
(lookup_device; the classifier's MC_DEVICE_CLASSIFY route).

Keys are strictly increasing: every producer gives them so (count_kmers,
from_pairs, checkpoint.load, whose shards are contiguous key ranges), and
every lookup searches them -- get_many on the host, lookup_device on the
device, and the native FIFO (csrc/bfs.cpp) with std::lower_bound.

Count semantics per the reference map (itmo:structures/map/Long2ShortHashMap.java):
get() of an absent key -> -1 (:159-175), counts saturate at 32767
(itmo:utils/NumUtils.java:21-26).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from . import trace

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
        self._device: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
        self._device_lock = threading.Lock()
        self._table_lock = threading.Lock()  # the probe table's one build

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
        """Host open-addressing table for bulk lookups, built once per map
        (under a lock: threads share a map, and a thread that finds a build
        under way waits for it). Only bulk callers build it (the classifiers
        and load_present_kmer_strings, before their first lookup); once
        built, get_many answers from it.

        np.searchsorted costs ~290 ns/query on large maps (measured round 4:
        96% of find_reads); linear-probe rounds over a lightly-loaded table
        resolve most queries in 1-2 gathers. Slot emptiness is encoded in
        the counts array (sentinel -2) so each probe round gathers keys +
        counts only -- no key sentinel is stolen (hashed k>31 keys span the
        full int64 range)."""
        cached = getattr(self, "_ptable", None)
        if cached is not None:
            return cached
        with self._table_lock:
            cached = getattr(self, "_ptable", None)
            if cached is None:
                trace.count("tables.probe")
                with trace.span("kmap.probe_table", map_keys=self.keys.size):
                    cached = self._ptable = self._build_probe_table()
        return cached

    def _build_probe_table(self):
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
        return tkeys, tcnts, np.int64(cap - 1)

    def get_many(self, query: np.ndarray) -> np.ndarray:
        """Vectorized count lookup; absent -> -1 (Long2ShortHashMap.get
        semantics, itmo:structures/map/Long2ShortHashMap.java:159-175).

        Probes the table where a bulk caller has built it, and otherwise
        searches the sorted keys: a table of the whole map costs more to
        build than the few thousand lookups of a gene environment."""
        query = np.asarray(query, np.int64)
        if self.keys.size == 0:
            return np.full(query.shape, -1, np.int32)
        q = np.ascontiguousarray(query.ravel())
        table = getattr(self, "_ptable", None)
        if table is None:
            return self._search(q).reshape(query.shape)
        return self._probe(q, *table).reshape(query.shape)

    def _search(self, q: np.ndarray) -> np.ndarray:
        """Counts of `q` by a search of the sorted keys, the queries taken
        in sorted order (each search starts near the last one's end)."""
        order = np.argsort(q)
        qs = q[order]
        pos = np.searchsorted(self.keys, qs)
        np.minimum(pos, self.keys.size - 1, out=pos)
        out = np.empty(q.size, np.int32)
        out[order] = np.where(self.keys[pos] == qs, self.counts[pos], -1)
        return out

    def _probe(self, q: np.ndarray, tkeys: np.ndarray, tcnts: np.ndarray,
               mask: np.int64) -> np.ndarray:
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
        return out

    def get(self, key: int) -> int:
        return int(self.get_many(np.array([key], np.int64))[0])

    def contains(self, query: np.ndarray) -> np.ndarray:
        return self.get_many(query) >= 0

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

    # ---- device side ----
    def device_arrays(self, device: torch.device
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The sorted (keys int64, counts int32) on `device`, copied once per
        device and cached (under a lock: classifier threads share a map)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._device_lock:
            arrays = self._device.get(device)
            if arrays is None:
                arrays = (torch.from_numpy(self.keys).to(device),
                          torch.from_numpy(self.counts).to(device))
                self._device[device] = arrays
        return arrays

    def lookup_device(self, query: torch.Tensor) -> torch.Tensor:
        """Counts of int64 `query` keys on the query's device; absent -> -1."""
        keys, counts = self.device_arrays(query.device)
        return _lookup_sorted(keys, counts, query)


def _lookup_sorted(keys: torch.Tensor, counts: torch.Tensor,
                   query: torch.Tensor) -> torch.Tensor:
    """int32 count of each query in the sorted `keys` (left-side
    searchsorted, as jnp.searchsorted), -1 where absent or the map is empty."""
    if keys.numel() == 0:
        return torch.full(query.shape, -1, dtype=torch.int32,
                          device=query.device)
    pos = torch.searchsorted(keys, query).clamp_max_(keys.numel() - 1)
    hit = keys[pos] == query
    return torch.where(hit, counts[pos], -1).to(torch.int32)
