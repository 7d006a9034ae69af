"""Hashed-regime (k > 31) layer-synchronous BFS on the device (B15).

Counterpart of metacherchant_tpu/ops/bfs_hashed.py, XLA ops in the JAX
package (no Pallas kernel), so plain torch on the device of device.py.
Arbitrary k needs W = ceil(k/32) words per state: states are (N, W) rows of
64-bit words, 2-bit packed big-endian (nucleotide p in word p//32 at bit
offset 62 - 2*(p%32)), so word-wise order equals string order over the
numeric alphabet.

torch has no uint64 shift on the CPU (ROADMAP C1), so the words are int64
bit patterns: every logical right shift is an arithmetic one masked to the
bits it keeps (_srl), products wrap mod 2^64 as uint64 ones do, and the
canonical hash is the signed min of the Java longs, as in ops/kmers.py.

- neighbors: multiword funnel shifts (StringUtils.java:8-32, no strings);
- coverage: the poly / FNV-1a canonical hash recomputed from the packed
  words (src/utils/PolynomialHash.java:7-28, src/utils/FNV1AHash.java:8-42)
  and looked up in the map's sorted device arrays
  (kmer_map._lookup_sorted, B10);
- dedup: torch.unique over rows (JAX lexsorts; callers take the visited
  rows as an unordered set);
- visited: an open-addressing set of ORIENTED rows (Java keys its distance
  map by the literal k-mer string, OneSequenceCalculator.java:200), sized as
  in the JAX package, 2^ceil(log2(2 * map / 0.5 + 2)) slots. JAX elects a
  slot's owner by scattering whole rows and reading them back; on a GPU two
  claimants' W-word rows can interleave into a torn row that no lane
  inserted. Here a slot is claimed with one word, the claiming lane's index
  in `owner` (-1 = empty), and only the winner writes its row.

MAX_RADIUS is exact under layer synchrony; MAX_KMERS and trim are
admission-order dependent and stay on the host engines
(algo/environment_hashed.py). The frontier is kept at its true size.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..kmer_map import _lookup_sorted
from .hashtable import _mix64, _srl
from .kmers import FNV_OFFSET_BASIS, FNV_PRIME, _i64, _powers

logger = logging.getLogger("metacherchant")

_GOLDEN = _i64(0x9E3779B97F4A7C15)


def words_of(k: int) -> int:
    return (k + 31) // 32


def _last_mask(k: int) -> int:
    """Mask of the used bits of the last word, as int64 bits (-1 at a full
    word)."""
    k_last = k - 32 * (words_of(k) - 1)
    return _i64(((1 << (2 * k_last)) - 1) << (64 - 2 * k_last))


def pack_rows_np(rows: np.ndarray, k: int) -> np.ndarray:
    """(N, k) uint8 nucleotide codes -> (N, W) uint64 packed states."""
    rows = np.asarray(rows, np.uint64)
    out = np.zeros((rows.shape[0], words_of(k)), np.uint64)
    for p in range(k):
        out[:, p // 32] |= rows[:, p] << np.uint64(62 - 2 * (p % 32))
    return out


def unpack_rows_np(packed: np.ndarray, k: int) -> np.ndarray:
    """(N, W) uint64 -> (N, k) uint8."""
    packed = np.asarray(packed, np.uint64)
    out = np.empty((packed.shape[0], k), np.uint8)
    for p in range(k):
        out[:, p] = (packed[:, p // 32] >> np.uint64(62 - 2 * (p % 32))) \
            & np.uint64(3)
    return out


def _mw_neighbors(states: torch.Tensor, k: int, direction: int
                  ) -> torch.Tensor:
    """(N, W) states -> (N, D, W) neighbors, interleaved (l_n, r_n) per
    nucleotide for direction 0 (StringUtils.allNeighbors order)."""
    N, W = states.shape
    lm = _last_mask(k)
    k_last = k - 32 * (W - 1)
    nucs = torch.arange(4, dtype=torch.int64, device=states.device)
    out = []
    if direction != 1:
        # left neighbor n + s[:-1]: shift right 2 bits across words
        sr = _srl(states, 2)
        sr[:, 1:] |= states[:, :-1] << 62
        left = sr[:, None, :].repeat(1, 4, 1)
        left[:, :, 0] |= nucs[None, :] << 62
        left[:, :, W - 1] &= lm
        out.append(left)
    if direction != -1:
        # right neighbor s[1:] + n: shift left 2 bits across words
        sl = states << 2
        sl[:, :-1] |= _srl(states[:, 1:], 62)
        right = sl[:, None, :].repeat(1, 4, 1)
        right[:, :, W - 1] = ((right[:, :, W - 1] & lm)
                              | (nucs[None, :] << (64 - 2 * k_last)))
        out.append(right)
    if len(out) == 1:
        return out[0]
    return torch.stack(out, dim=2).reshape(N, 8, W)


def _mw_codes(states: torch.Tensor, k: int) -> torch.Tensor:
    """(N, W) packed states -> (N, k) int64 nucleotide codes."""
    shifts = torch.arange(62, -1, -2, device=states.device)
    codes = (states[:, :, None] >> shifts) & 3
    return codes.reshape(states.shape[0], -1)[:, :k]


def _mw_hash(states: torch.Tensor, k: int, hasher: str) -> torch.Tensor:
    """(N, W) -> (N,) int64 canonical hash (signed min of fw/rc). poly in
    closed form, sums mod 2^64 (src/utils/PolynomialHash.java:19-28):
        fw = 5^k + sum_t c[t] * 5^(k-1-t),  rc = 5^k + sum_u (3^c[u]) * 5^u;
    FNV-1a, which has no closed form, by its k xor-multiply steps."""
    c = _mw_codes(states, k)
    if hasher == "poly":
        pow5, _ = _powers(k, states.device)
        fw = pow5[k] + (c * pow5[:k].flip(0)).sum(dim=1)
        rc = pow5[k] + ((c ^ 3) * pow5[:k]).sum(dim=1)
        return torch.minimum(fw, rc)
    fw = torch.full((c.shape[0],), _i64(FNV_OFFSET_BASIS), dtype=torch.int64,
                    device=states.device)
    rc = fw.clone()
    for t in range(k):
        fw = (fw ^ c[:, t]) * FNV_PRIME
        rc = (rc ^ (c[:, k - 1 - t] ^ 3)) * FNV_PRIME
    return torch.minimum(fw, rc)


def _mw_slot(states: torch.Tensor, cmask: int) -> torch.Tensor:
    """(N, W) -> (N,) int64 open-addressing start slot (fold words, mix)."""
    h = states[:, 0]
    for i in range(1, states.shape[1]):
        h = (h * _GOLDEN) ^ states[:, i]
    return _mix64(h) & cmask


def _mw_unique(states: torch.Tensor) -> torch.Tensor:
    """The distinct rows (sorted by torch.unique; the order is not used)."""
    if states.shape[0] == 0:
        return states
    return torch.unique(states, dim=0)


def _mwset_insert(skeys: torch.Tensor, owner: torch.Tensor, b: torch.Tensor
                  ) -> tuple[int, torch.Tensor]:
    """Insert unique (N, W) rows, in place; returns (n_new, won): won[i] is
    True iff b[i] was NOT in the set before -- a combined membership test
    and insert, as bfs_device._set_insert (JAX's separate _mwset_lookup is
    not carried).

    Election with one word: each lane that finds its slot empty writes its
    lane index into owner[slot]; the lane that reads its own index back
    wins and alone writes its row, so no slot holds a torn row."""
    C = owner.numel()
    won = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    lane = torch.arange(b.shape[0], dtype=torch.int32, device=b.device)
    rows, slot = b, _mw_slot(b, C - 1)
    for _ in range(C):
        if lane.numel() == 0:
            break
        cur = owner[slot]
        empty = cur < 0
        match = ~empty & (skeys[slot] == rows).all(dim=1)
        owner[slot[empty]] = lane[empty]
        win = empty & (owner[slot] == lane)
        skeys[slot[win]] = rows[win]
        won[lane[win].long()] = True
        keep = ~(match | win)
        lane, rows, slot = lane[keep], rows[keep], (slot[keep] + 1) & (C - 1)
    if lane.numel():  # pragma: no cover - the set is sized from the map
        raise RuntimeError("device BFS visited set is full")
    return int(won.sum()), won


def device_bfs_mw(seeds: torch.Tensor, mkeys: torch.Tensor,
                  mcounts: torch.Tensor, min_occ: int, max_radius: int,
                  k: int, hasher: str, direction: int, visited_log2: int
                  ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """The whole hashed-regime BFS from (S, W) packed oriented seed states.

    Returns (visited rows skeys (C, W), owner (C,) int32 with -1 at empty
    slots, n_visited, layers run)."""
    C = 1 << visited_log2
    W = words_of(k)
    skeys = torch.zeros((C, W), dtype=torch.int64, device=seeds.device)
    owner = torch.full((C,), -1, dtype=torch.int32, device=seeds.device)
    frontier = _mw_unique(seeds)
    count, _ = _mwset_insert(skeys, owner, frontier)
    d = 1
    while frontier.shape[0] and d <= max_radius:
        cand = _mw_neighbors(frontier, k, direction).reshape(-1, W)
        occ = _lookup_sorted(mkeys, mcounts, _mw_hash(cand, k, hasher))
        cand = _mw_unique(cand[occ >= min_occ])
        new, won = _mwset_insert(skeys, owner, cand)
        frontier = cand[won]
        count += new
        d += 1
    return skeys, owner, count, d - 1


def run_device_bfs_hashed(seed_rows: np.ndarray, kmap, k: int, min_occ: int,
                          hasher: str, direction: int,
                          max_radius: int | None, *,
                          device: torch.device) -> np.ndarray:
    """(S, k) uint8 seed rows -> (V, k) uint8 visited oriented rows
    (unordered), on `device`; kmap: KmerMap with sorted (keys, counts)."""
    if seed_rows.shape[0] == 0:
        return np.empty((0, k), np.uint8)
    packed = pack_rows_np(seed_rows, k).view(np.int64)
    est = max(len(kmap), 1)
    visited_log2 = max(int(np.ceil(np.log2(2 * est / 0.5 + 2))), 6)
    mr = max_radius if max_radius is not None else 1 << 30
    mkeys, mcounts = kmap.device_arrays(device)
    t0 = time.perf_counter()
    skeys, owner, count, layers = device_bfs_mw(
        torch.from_numpy(packed).to(mkeys.device), mkeys, mcounts, min_occ,
        mr, k, hasher, direction, visited_log2)
    rows = skeys[owner >= 0].cpu().numpy()
    logger.debug("multiword device BFS, direction %d: %d layers, %d visited, "
                 "%.3f s", direction, layers, count, time.perf_counter() - t0)
    return unpack_rows_np(rows.view(np.uint64), k)
