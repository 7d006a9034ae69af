"""Multi-device environment BFS: hash-sharded table + frontier exchange (B17).

Counterpart of metacherchant_tpu/parallel/sharded_bfs.py, XLA ops under
shard_map in the JAX package (no Pallas kernel), so plain torch plus
torch.distributed here, one process per device. The coverage table and the
visited set are both sharded by canonical key, with the owner of sharded
counting (mix64(key) mod n), and each layer's candidate states go to their
owner with one all_to_all_single:

  per layer, on every rank:
    1. expand the local frontier to its 4 or 8 neighbor codes (bit ops);
    2. dedup them locally (_unique_pad) and bucket them by
       owner(canonical(state)), cap bucket_cap per owner;
    3. all_to_all_single of the buckets;
    4. on the owner: look the canonical keys up in the local table shard
       (count >= min_occ; ops/hashtable._lookup is JAX's _table_lookup),
       dedup, and insert into the local ORIENTED visited set;
    5. the states that were new are the owner's next frontier (states live
       where their canonical key lives);
    6. one all_reduce of (new states, overflow flags): the loop ends when no
       rank admitted a state, or past max_radius.

JAX runs the loop in one jitted while_loop; here the host runs it, one
all_reduce per layer. No tool calls it, as in the JAX package.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.bfs_device import (_canonical_dev, _neighbors_dev, _set_insert,
                              _unique_pad)
from ..ops.hashtable import EMPTY, _insert_unique, _lookup
from ..ops.kmers import SENTINEL
from .distributed import initialize_distributed, local_device
from .sharded_count import (_all_reduce, _owner, _owner_slots,
                            all_gather_items)

logger = logging.getLogger("metacherchant")


def _bucket_states(states: torch.Tensor, n: int, cap: int, k: int
                   ) -> tuple[torch.Tensor, bool]:
    """Pack oriented states (SENTINEL lanes skip) into (n, cap) buckets by
    owner(canonical(state)). Returns (buckets, overflowed)."""
    live = states[states != SENTINEL]
    order, slot = _owner_slots(_owner(_canonical_dev(live, k), n), cap)
    ok = slot >= 0
    out = torch.full((n * cap,), SENTINEL, dtype=torch.int64,
                     device=states.device)
    out[slot[ok]] = live[order][ok]
    return out.view(n, cap), bool((~ok).any())


def _owners_np(keys: np.ndarray, n: int) -> np.ndarray:
    return _owner(torch.from_numpy(np.asarray(keys, np.int64)), n).numpy()


def build_sharded_table(kmap, capacity_log2: int | None = None, *,
                        device: torch.device
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's open-addressing shard of a KmerMap: the keys it owns
    (owner(key) = mix64(key) mod n), sized for the densest shard at load
    0.5 unless capacity_log2 is given. Returns (tkeys, tcnts)."""
    n, rank = dist.get_world_size(), dist.get_rank()
    keys, counts = kmap.keys, kmap.counts
    owner = _owners_np(keys, n)
    need = max(int(np.bincount(owner, minlength=n).max()) if keys.size
               else 1, 1)
    if capacity_log2 is None:
        capacity_log2 = max(int(np.ceil(np.log2(need / 0.5 + 1))), 6)
    tkeys = torch.full((1 << capacity_log2,), EMPTY, dtype=torch.int64,
                       device=device)
    tcnts = torch.zeros(1 << capacity_log2, dtype=torch.int32, device=device)
    mine = owner == rank
    _, residual = _insert_unique(
        tkeys, tcnts, torch.from_numpy(keys[mine]).to(device),
        torch.from_numpy(np.asarray(counts[mine], np.int32)).to(device))
    if residual.numel():
        raise RuntimeError("sharded table build overflow")
    return tkeys, tcnts


def run_sharded_bfs(seed_codes: np.ndarray, kmap, k: int, min_occ: int,
                    direction: int, max_radius: int | None,
                    frontier_cap: int | None = None, *,
                    device: torch.device) -> np.ndarray:
    """Sorted oriented visited codes of all shards, on every rank (every
    rank passes the same seeds and map; a group of world size 1 is formed
    when none exists).

    frontier_cap bounds the per-shard per-layer frontier (rounded up to a
    power of two, at least 64); the default, twice the per-shard map size,
    is always safe. A cap below the densest shard's unique seeds raises
    ValueError before the table is built; a layer past the cap, or a bucket
    past bucket_cap, raises RuntimeError."""
    initialize_distributed(device=device)
    device = local_device(device)
    n = dist.get_world_size()
    if seed_codes.size == 0:
        return np.empty(0, np.int64)
    est = max(len(kmap), 1)
    requested_cap = frontier_cap
    if frontier_cap is None:
        frontier_cap = 1 << max(int(np.ceil(np.log2(2 * est / n + 2))) + 1, 6)
    else:
        frontier_cap = 1 << int(np.ceil(np.log2(max(frontier_cap, 64))))
    visited_log2 = max(int(np.ceil(np.log2(2 * est / n / 0.5 + 2))) + 1, 6)
    D = 8 if direction == 0 else 4
    bucket_cap = max((frontier_cap * D) // n * 2, 64)

    # dedup first, as JAX does: the frontier init dedups oriented seeds, so
    # raw duplicates must not count against the cap
    seeds = np.unique(np.asarray(seed_codes, np.int64))
    owner = _owners_np(_canonical_dev(torch.from_numpy(seeds), k).numpy(), n)
    max_bucket = int(np.bincount(owner, minlength=n).max())
    if max_bucket > frontier_cap:
        raise ValueError(
            f"frontier_cap {requested_cap} (rounded {frontier_cap}) below "
            f"the densest seed shard ({max_bucket} unique seeds)")

    t0 = time.perf_counter()
    tkeys, tcnts = build_sharded_table(kmap, device=device)
    vset = torch.full((1 << visited_log2,), EMPTY, dtype=torch.int64,
                      device=device)
    frontier = torch.from_numpy(seeds[owner == dist.get_rank()]).to(device)
    _set_insert(vset, frontier)
    (active,) = _all_reduce([frontier.numel()], dist.ReduceOp.SUM,
                            device=device)
    d, overflow = 1, False
    mr = max_radius if max_radius is not None else 1 << 30
    while active and d <= mr and not overflow:
        cand = _unique_pad(_neighbors_dev(frontier, k, direction))
        buckets, ovf1 = _bucket_states(cand, n, bucket_cap, k)
        got = torch.empty_like(buckets)
        dist.all_to_all_single(got, buckets)
        got = got.view(-1)
        got = got[got != SENTINEL]
        occs = _lookup(tkeys, tcnts, _canonical_dev(got, k))
        got = torch.unique(got[occs >= min_occ])
        new, won = _set_insert(vset, got)
        frontier = got[won][:frontier_cap]
        d += 1
        flags, active = _all_reduce([int(ovf1 or new > frontier_cap), new],
                                    dist.ReduceOp.SUM, device=device)
        overflow = flags > 0
    if overflow:
        raise RuntimeError("sharded BFS frontier/bucket overflow")
    visited = vset[vset != EMPTY]
    keys, _ = all_gather_items(visited, torch.zeros_like(visited))
    logger.debug("sharded BFS, direction %d: %d layers, %d visited on %d "
                 "ranks, %.3f s", direction, d - 1, keys.numel(), n,
                 time.perf_counter() - t0)
    return torch.sort(keys).values.cpu().numpy()
