"""Layer-synchronous BFS with an open-addressing visited set (B14).

Counterpart of metacherchant_tpu/ops/bfs_device.py (the `probe` engine of
MC_DEVICE_BFS_ENGINE), XLA ops in the JAX package (no Pallas kernel), so
plain torch on the device of device.py. State on the device:

- coverage: the (tkeys, tcnts) probe table of ops/hashtable.DeviceHashTable;
- visited: an open-addressing set of ORIENTED k-mer codes (Java keys its
  distance map by the literal k-mer string, not the canonical form),
  2^ceil(log2(2 * map / 0.25 + 2)) slots as in the JAX package (2^28 int64,
  2.1 GB, at 22.4M k-mers);
- frontier: the layer's new codes, at their true size. JAX pads it to
  frontier_cap lanes, by default twice the map (2^26 lanes x 8 neighbors at
  22.4M k-mers); here frontier_cap only bounds it, and raises when passed.

Per layer: expand the frontier to its 4 or 8 neighbor codes (bit ops),
probe their coverage (count >= min_occ), dedup (torch.unique, where JAX
sorts and pads in _unique_pad), then one combined membership test and
insert into the visited set: the lanes that win a slot are the fresh ones
and form the next frontier (JAX's separate _set_lookup has no caller and
is not carried). The host reads the frontier's size once per
layer. MAX_RADIUS is exact under layer synchrony (TerminationMode.java
:31-47); MAX_KMERS stays on the host FIFO (algo/environment.py).
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .contraction_device import _revcomp
from .hashtable import DeviceHashTable, EMPTY, _lookup, _probe_claim

logger = logging.getLogger("metacherchant")


def _neighbors_dev(codes: torch.Tensor, k: int, direction: int
                   ) -> torch.Tensor:
    """(F,) oriented codes -> (F * D,) neighbor codes: left n + s[:-1] for
    direction -1, right s[1:] + n for +1, both for 0."""
    nucs = torch.arange(4, dtype=torch.int64, device=codes.device)
    parts = []
    if direction != 1:
        parts.append((codes[:, None] >> 2) | (nucs[None, :] << (2 * k - 2)))
    if direction != -1:
        parts.append(((codes[:, None] << 2) & ((1 << (2 * k)) - 1))
                     | nucs[None, :])
    return torch.cat(parts, dim=1).reshape(-1)


def _canonical_dev(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Numeric-min canonical key (itmo:utils/KmerUtils.java:59-61)."""
    return torch.minimum(codes, _revcomp(codes, k))


def _set_insert(skeys: torch.Tensor, bkeys: torch.Tensor
                ) -> tuple[int, torch.Tensor]:
    """Insert unique keys into the set, in place; returns (n_new, won):
    won[i] is True iff bkeys[i] was NOT in the set before -- a combined
    membership test and insert."""
    _, won, residual = _probe_claim(skeys, bkeys, skeys.numel())
    if residual.numel():  # pragma: no cover - the set is sized from the map
        raise RuntimeError("device BFS visited set is full")
    return int(won.sum()), won


def device_bfs(seeds: torch.Tensor, tkeys: torch.Tensor, tcnts: torch.Tensor,
               min_occ: int, max_radius: int, k: int, direction: int,
               visited_log2: int, frontier_cap: int | None = None
               ) -> tuple[torch.Tensor, int, list[int]]:
    """The whole BFS from (S,) oriented seed codes on their device.

    Returns (visited set keys (2^visited_log2,), n_visited, the number of
    fresh codes per layer). Raises when a layer's fresh codes exceed
    frontier_cap."""
    vset = torch.full((1 << visited_log2,), EMPTY, dtype=torch.int64,
                      device=seeds.device)
    frontier = torch.unique(seeds)
    count, _ = _set_insert(vset, frontier)
    sizes = []
    d = 1
    while frontier.numel() and d <= max_radius:
        cand = _neighbors_dev(frontier, k, direction)
        occs = _lookup(tkeys, tcnts, _canonical_dev(cand, k))
        cand = torch.unique(cand[occs >= min_occ])
        new, won = _set_insert(vset, cand)
        if frontier_cap is not None and new > frontier_cap:
            raise RuntimeError(f"device BFS frontier overflow: {new} fresh "
                               f"codes at distance {d}, cap {frontier_cap}")
        frontier = cand[won]
        count += new
        sizes.append(new)
        d += 1
    return vset, count, sizes


def run_device_bfs(seed_codes: np.ndarray, kmap_or_table, k: int,
                   min_occ: int, direction: int, max_radius: int | None,
                   frontier_cap: int | None = None, *,
                   device: torch.device) -> np.ndarray:
    """Sorted oriented visited codes (numpy), set-identical to
    algo.environment.bfs_layered (radius-only termination).

    kmap_or_table: a KmerMap (turned into a DeviceHashTable on `device`) or
    a DeviceHashTable. frontier_cap: when given, a layer with more fresh
    codes raises instead of being cut."""
    if seed_codes.size == 0:
        return np.empty(0, np.int64)
    if isinstance(kmap_or_table, DeviceHashTable):
        table, est = kmap_or_table, kmap_or_table.size
    else:
        table = DeviceHashTable.from_kmer_map(kmap_or_table, device)
        est = len(kmap_or_table)
    visited_log2 = max(int(np.ceil(np.log2(2 * est / 0.25 + 2))), 6)
    mr = max_radius if max_radius is not None else 1 << 30
    t0 = time.perf_counter()
    vset, count, sizes = device_bfs(
        torch.from_numpy(np.asarray(seed_codes, np.int64)).to(table.device),
        table.tkeys, table.tcnts, min_occ, mr, k, direction, visited_log2,
        frontier_cap)
    out = vset[vset != EMPTY].cpu().numpy()
    logger.debug("probe device BFS, direction %d: %d layers, %d visited, "
                 "%.3f s", direction, len(sizes), count,
                 time.perf_counter() - t0)
    out.sort()
    return out
