"""Dense-frontier BFS over a precomputed de Bruijn adjacency (B13).

Counterpart of metacherchant_tpu/ops/bfs_dense.py, XLA ops in the JAX
package (no Pallas kernel), so plain torch on the device of device.py.

1. BUILD (once per map and device): the 8 neighbor candidates of every
   oriented k-mer of the map, canonicalized, are looked up in the sorted
   key store with torch.searchsorted against KmerMap.device_arrays (B10),
   giving the dense adjacency (oriented node id = 2 * canonical rank +
   orientation bit): left (2n, 4) and right (2n, 4) int32 neighbor ids by
   nucleotide (StringUtils.java:8-22), the JAX package's (2n, 8) adj
   split into its two column halves, each contiguous. The JAX package
   joins by sorting to reuse its cached TPU sort executables
   (bfs_dense.py:13-17); a GPU searches instead, so its join lane budget
   (ROADMAP C5(d)) has no counterpart. The build runs in chunks of
   oriented nodes: at 22.4M k-mers the adjacency is 1.43 GB (64 B per
   k-mer) and the whole query set would be 358M int64 per temporary.
2. TRAVERSE: frontier and visited are bitmaps over the 2n oriented ids.
   A layer is one gather of the frontier through a contiguous half
   (index_select with int32 ids; advanced indexing through a strided view
   of the (2n, 8) table took 4.6 ms a layer at 22.4M k-mers on the H100)
   plus elementwise and/or/not; a bitmap holds no duplicates, so dedup and
   the visited anti-join are free.
   JAX runs the loop in one while_loop; here the host reads any(frontier)
   once per layer.

Arrays are sized exactly (no power-of-two padding): an absent neighbor
points at id 2n, one False lane appended to the frontier for the gather,
which no eligibility mask covers, so no pad lane is ever reached (the JAX
package's pad lanes are eligible at min_occ <= 0, ROADMAP C5(a)).

Exact regime only (k <= 31). MAX_KMERS and lastKmers stay on the host FIFO
(admission-order dependent, TerminationMode.java:38-39); the visited set
equals algo.environment.bfs_layered's under radius-only termination.
"""
from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from ..dna import revcomp_codes_np
from .contraction_device import _revcomp

logger = logging.getLogger("metacherchant")

#: canonical k-mers per build chunk: 2^21 -> 2^22 oriented nodes, 2^25
#: neighbor queries, 256 MB per int64 temporary
_BUILD_CHUNK = 1 << 21

_graph_lock = threading.Lock()


class DenseDBG:
    """The dense adjacency of a KmerMap's canonical key store on a device."""

    def __init__(self, keys: torch.Tensor, counts: torch.Tensor, k: int):
        """keys: sorted canonical keys, counts their counts, on one device
        (KmerMap.device_arrays)."""
        if k > 31:
            raise ValueError("dense BFS engine is exact-regime only (k<=31)")
        self.k = k
        self.n = keys.numel()
        self.pad_id = 2 * self.n
        self.keys, self.counts = keys, counts
        self.keys_host = keys.cpu().numpy()
        dev = keys.device
        self.left = torch.empty((2 * self.n, 4), dtype=torch.int32,
                                device=dev)
        self.right = torch.empty_like(self.left)
        mask = (1 << (2 * k)) - 1
        nucs = torch.arange(4, dtype=torch.int64, device=dev)
        for i0 in range(0, self.n, _BUILD_CHUNK):
            kp = keys[i0:i0 + _BUILD_CHUNK]
            ocodes = torch.stack([kp, _revcomp(kp, k)], dim=1).reshape(-1)
            ids = self._neighbor_ids(ocodes, k, mask, nucs)
            rows = slice(2 * i0, 2 * i0 + ocodes.numel())
            self.left[rows], self.right[rows] = ids[:, :4], ids[:, 4:]
        self._eligible: dict[int, torch.Tensor] = {}

    def _neighbor_ids(self, ocodes: torch.Tensor, k: int, mask: int,
                      nucs: torch.Tensor) -> torch.Tensor:
        """(m,) oriented codes -> (m, 8) int32 oriented ids of their
        neighbors in the map, pad_id where absent (_oriented_queries and the
        join of the JAX package)."""
        left = (ocodes[:, None] >> 2) | (nucs[None, :] << (2 * k - 2))
        right = ((ocodes[:, None] << 2) & mask) | nucs[None, :]
        nbr = torch.cat([left, right], dim=1)
        canon = torch.minimum(nbr, _revcomp(nbr, k))
        pos = torch.searchsorted(self.keys, canon).clamp_max_(self.n - 1)
        hit = self.keys[pos] == canon
        ids = 2 * pos + (nbr != canon)
        return torch.where(hit, ids, self.pad_id).to(torch.int32)

    def eligible(self, min_occ: int) -> torch.Tensor:
        """(2n,) oriented-node admissibility: canonical count >= min_occ
        (OneSequenceCalculator.runBfs:203 coverage check)."""
        got = self._eligible.get(min_occ)
        if got is None:
            got = (self.counts >= min_occ).repeat_interleave(2)
            self._eligible[min_occ] = got
        return got

    def seed_vector(self, seed_codes: np.ndarray
                    ) -> tuple[torch.Tensor, np.ndarray]:
        """Oriented codes -> ((2n,) bool seed bitmap on the device,
        out-of-map mask on the host)."""
        seed_codes = np.asarray(seed_codes, np.int64)
        dense = torch.zeros(2 * self.n, dtype=torch.bool,
                            device=self.keys.device)
        if self.n == 0:  # empty map: every seed is out-of-map
            return dense, np.ones(seed_codes.size, bool)
        canon = np.minimum(seed_codes, revcomp_codes_np(seed_codes, self.k))
        pos = np.minimum(np.searchsorted(self.keys_host, canon), self.n - 1)
        in_map = self.keys_host[pos] == canon
        ids = 2 * pos + (seed_codes != canon)
        dense[torch.from_numpy(ids[in_map]).to(dense.device)] = True
        return dense, ~in_map

    def ids_to_codes(self, ids: torch.Tensor) -> torch.Tensor:
        """Oriented node ids -> oriented codes, on the device."""
        canon = self.keys[ids >> 1]
        return torch.where((ids & 1) == 1, _revcomp(canon, self.k), canon)


def _pull(f_ext: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """(2n,) bool: some neighbor id in a (2n, 4) half is set in f_ext."""
    return f_ext.index_select(0, half.view(-1)).view(-1, 4).any(dim=1)


def dense_bfs(g: DenseDBG, eligible: torch.Tensor, seeds: torch.Tensor,
              max_radius: int, direction: int
              ) -> tuple[torch.Tensor, int]:
    """Layer-synchronous pull BFS over dense oriented-node bitmaps.

    direction 0: both halves. +1 (right-extension BFS): node i joins the
    frontier iff one of its LEFT neighbors is in it (x right-extends to i
    <=> i left-shrinks to x); -1 symmetric. Returns ((2n,) visited bitmap,
    layers run)."""
    halves = {1: (g.left,), -1: (g.right,)}.get(direction, (g.left, g.right))
    frontier, visited = seeds, seeds.clone()
    pad = torch.zeros(1, dtype=torch.bool, device=seeds.device)
    d, layers = 1, 0
    while d <= max_radius and bool(frontier.any()):
        f_ext = torch.cat([frontier, pad])
        cand = _pull(f_ext, halves[0])
        for half in halves[1:]:
            cand |= _pull(f_ext, half)
        frontier = cand & eligible & ~visited
        visited |= frontier
        d += 1
        layers += 1
    return visited, layers


def _graph_of(kmap, k: int, device: torch.device) -> DenseDBG:
    """Build-or-reuse the DenseDBG of a KmerMap on `device`, cached on the
    map per device (environment-finder's per-gene threads share one map)."""
    keys, counts = kmap.device_arrays(device)
    with _graph_lock:
        cache = kmap.__dict__.setdefault("_dense_dbg", {})
        g = cache.get(keys.device)
        if g is None or g.k != k:
            t0 = time.perf_counter()
            g = DenseDBG(keys, counts, k)
            cache[keys.device] = g
            logger.debug("DenseDBG of %d k-mers built in %.3f s on %s", g.n,
                         time.perf_counter() - t0, keys.device)
    return g


def run_dense_bfs(seed_codes: np.ndarray, kmap, k: int, min_occ: int,
                  direction: int, max_radius: int | None, *,
                  device: torch.device) -> np.ndarray:
    """Sorted oriented visited codes, set-identical to
    algo.environment.bfs_layered (radius-only termination).

    Out-of-map seeds (possible only when min_occ <= 0 upstream) are handled
    by a second pass: their eligible in-map neighbors are distance-1
    sources, and multi-source BFS with per-source budgets decomposes into a
    union of single-budget runs."""
    if seed_codes.size == 0:
        return np.empty(0, np.int64)
    if min_occ < 0:
        # a negative threshold admits ABSENT k-mers (map lookups return -1),
        # which have no dense node id -- only the host engines expand them
        raise ValueError("dense BFS requires min_occ >= 0")
    g = _graph_of(kmap, k, device)
    mr = min(max_radius if max_radius is not None else 1 << 30, 1 << 30)
    elig = g.eligible(min_occ)
    seeds_dense, oom = g.seed_vector(seed_codes)
    t0 = time.perf_counter()
    visited, layers = dense_bfs(g, elig, seeds_dense, mr, direction)
    parts = []
    if oom.any():
        # out-of-map seeds: admit them verbatim (bfs_layered admits every
        # seed), then flood from their eligible neighbors with radius - 1
        from ..algo.environment import neighbors_codes
        oom_codes = np.unique(seed_codes[oom])
        parts.append(oom_codes)
        if mr >= 1:
            nbr = neighbors_codes(oom_codes, k, direction).reshape(-1)
            canon = np.minimum(nbr, revcomp_codes_np(nbr, k))
            nbr = nbr[kmap.get_many(canon) >= min_occ]
            if nbr.size:
                d2, oom2 = g.seed_vector(nbr)
                if oom2.any():  # pragma: no cover - min_occ >= 0 forbids it
                    raise RuntimeError("dense BFS: covered neighbor not in map")
                v2, _ = dense_bfs(g, elig, d2, mr - 1, direction)
                visited |= v2
    ids = torch.nonzero(visited).squeeze(1)
    parts.append(g.ids_to_codes(ids).cpu().numpy())
    logger.debug("dense device BFS, direction %d: %d layers, %.3f s",
                 direction, layers, time.perf_counter() - t0)
    return np.unique(np.concatenate(parts))
