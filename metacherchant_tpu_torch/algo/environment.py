"""Genomic-environment extraction: FIFO BFS over the counted dBG (host).

Carried over from metacherchant_tpu/algo/environment.py: the host engines of
the main path (native C++ FIFO BFS, the Python FIFO as its oracle, trim,
seeding, normalization). The JAX package's device BFS engines are not ported
yet; asking for them (MC_DEVICE_BFS, MC_DEVICE_BFS_MIN_SEEDS) raises.
k-mers are oriented 2-bit codes; coverage probes are vectorized lookups into
the k-mer map.

Semantics preserved exactly (set-wise) vs. the Java engine:
- BFS states are ORIENTED k-mers (Java keys distanceToKmer by the literal
  string, not its canonical form); the final subgraph collapses orientation
  via normalizeDna (OneSequenceCalculator.addToSubgraph:146-148)
- direction modes: bothdirs ? one pass dir=0 : two passes dir=-1,+1
  (buildEnvironment:137-144); left/right neighbors per StringUtils:8-32
- admission: neighbor count >= minOccurences AND TerminationMode.allowsAddition
  (not already visited; distance <= maxradius; |visited| < maxkmers)
  (runBfs:198-213, TerminationMode.allowsAddition:31-47)
- the FIFO engine keeps the Java queue order, so the admission-order
  dependent MAX_KMERS cap (TerminationMode.java:38-39) is exact
- lastKmers: a k-mer is recorded when one of its coverage-eligible neighbors is
  NOT admitted at its expansion (runBfs:209)
- trimPaths: reverse BFS from lastKmers restricted to visited states
  (runTrimPaths:241-262)
- extendEnvironment is a no-op on outputs in the reference: it sets cont=kmer
  (the *current* k-mer, already in the subgraph) rather than the neighbor, so
  additions only re-add existing keys (OneSequenceCalculator.extendEnvironment
  :265-295). We replicate the no-op and report the would-be count for log parity.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..kmer_map import KmerMap
from ..dna import revcomp_codes_np

_M5 = np.uint64(0x5555555555555555)


def ascii_rank_codes(codes: np.ndarray) -> np.ndarray:
    """Map packed codes so numeric order == ASCII-lex order of decoded strings.

    Codes use A=0,G=1,C=2,T=3 but ASCII sorts A<C<G<T: swap digit values 1<->2
    per 2-bit digit (digit d -> d ^ 3 iff d in {1,2}, i.e. xor with 3*(b0^b1)).
    """
    c = codes.astype(np.uint64)
    m = (c ^ (c >> np.uint64(1))) & _M5
    return (c ^ (m | (m << np.uint64(1)))).astype(np.int64)


def ascii_min_orient(codes: np.ndarray, k: int) -> np.ndarray:
    """For each oriented code, the orientation whose string is ASCII-lex minimal
    (= normalizeDna, src/utils/StringUtils.java:34-41)."""
    rc = revcomp_codes_np(codes, k)
    pick_rc = ascii_rank_codes(rc) < ascii_rank_codes(codes)
    return np.where(pick_rc, rc, codes)


def canonical_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Numeric-min canonical key (itmo:utils/KmerUtils.java:59-61)."""
    rc = revcomp_codes_np(codes, k)
    return np.minimum(codes, rc)


def neighbors_codes(codes: np.ndarray, k: int, direction: int) -> np.ndarray:
    """(F,) oriented codes -> (F, D) neighbor codes.

    direction -1: left neighbors n + kmer[:-1] (StringUtils.leftNeighbors:8-14)
    direction +1: right neighbors kmer[1:] + n (rightNeighbors:16-22)
    direction  0: interleaved [L0,R0,L1,R1,...] (allNeighbors:24-32) -- the
    interleaving order only matters for the sequential FIFO engine.
    """
    codes = codes.astype(np.int64)
    mask = np.int64((1 << (2 * k)) - 1)
    shift_hi = np.int64(2 * k - 2)
    nucs = np.arange(4, dtype=np.int64)
    left = (codes[:, None] >> 2) | (nucs[None, :] << shift_hi)
    right = ((codes[:, None] << 2) & mask) | nucs[None, :]
    if direction == -1:
        return left
    if direction == 1:
        return right
    out = np.empty((codes.shape[0], 8), np.int64)
    out[:, 0::2] = left
    out[:, 1::2] = right
    return out


def _in_sorted(sorted_arr: np.ndarray, queries: np.ndarray) -> np.ndarray:
    if sorted_arr.size == 0:
        return np.zeros(queries.shape, bool)
    pos = np.searchsorted(sorted_arr, queries)
    pos = np.minimum(pos, sorted_arr.size - 1)
    return sorted_arr[pos] == queries


@dataclass
class BfsResult:
    visited: np.ndarray          # oriented codes, sorted
    last_kmers: np.ndarray       # oriented codes (for trim), sorted unique
    fail: bool = False


def bfs_fifo(seed_list: list[int], kmap: KmerMap, k: int, min_occ: int,
             direction: int, max_radius: int | None, max_kmers: int | None,
             collect_last: bool = False) -> BfsResult:
    """Exact sequential FIFO engine -- the host default.

    Mirrors runBfs's queue order: seeds in sequence order, neighbors in
    getNeighborsByDir order (src/algo/OneSequenceCalculator.java:198-239), so
    it is exact for the order-dependent MAX_KMERS cap
    (TerminationMode.java:38-39) and for lastKmers collection (:209).

    The inner loop is pure Python over a both-orientations count dict
    (KmerMap.oriented_dict): gene environments are overwhelmingly DEEP and
    NARROW (the wiki example runs 93k layers at frontier <= 31), where
    per-layer vectorized ops cost more than scalar dict probes by ~10x
    (scripts/bench_bfs.py in the JAX package).
    """
    if not seed_list:
        return BfsResult(np.empty(0, np.int64), np.empty(0, np.int64), fail=True)
    from .. import native
    if native.bfs_available():
        # C++ FIFO engine (native/bfs.cpp): identical admission semantics,
        # ~100x the Python loop; equality pinned in tests/test_native_bfs.py
        vis, last = native.bfs_exact(
            kmap.keys, kmap.counts, np.asarray(seed_list, np.int64), k,
            min_occ, direction, max_radius, max_kmers, collect_last)
        return BfsResult(vis, last)
    counts = kmap.oriented_dict(k)
    get = counts.get
    mask = (1 << (2 * k)) - 1
    shift_hi = 2 * k - 2
    dist: dict[int, int] = {}
    queue: list[int] = []
    for s in seed_list:
        s = int(s)
        if s not in dist:
            dist[s] = 0
        queue.append(s)
    last: set[int] = set()
    head = 0
    while head < len(queue):
        cur = queue[head]
        head += 1
        dd = dist[cur] + 1
        # neighbor codes inline, in StringUtils order (left n+kmer[:-1] for
        # n in ACGT-code order; right kmer[1:]+n; dir 0 interleaved L0,R0,...)
        if direction == -1:
            sh = cur >> 2
            nbrs = (sh, sh | (1 << shift_hi), sh | (2 << shift_hi),
                    sh | (3 << shift_hi))
        elif direction == 1:
            sl = (cur << 2) & mask
            nbrs = (sl, sl | 1, sl | 2, sl | 3)
        else:
            sh = cur >> 2
            sl = (cur << 2) & mask
            nbrs = (sh, sl, sh | (1 << shift_hi), sl | 1,
                    sh | (2 << shift_hi), sl | 2,
                    sh | (3 << shift_hi), sl | 3)
        for nb in nbrs:
            oc = get(nb)
            if oc is not None and oc >= min_occ:
                allowed = nb not in dist
                if allowed and max_kmers is not None and len(dist) >= max_kmers:
                    allowed = False
                if allowed and max_radius is not None and dd > max_radius:
                    allowed = False
                if allowed:
                    queue.append(nb)
                    dist[nb] = dd
                elif collect_last:
                    last.add(cur)
    return BfsResult(
        np.array(sorted(dist.keys()), np.int64),
        np.array(sorted(last), np.int64))


def trim_paths(visited: np.ndarray, last_kmers: np.ndarray, k: int,
               direction: int) -> np.ndarray:
    """Reverse BFS from last_kmers restricted to the visited set; returns the
    retained subset (runTrimPaths, OneSequenceCalculator.java:241-262)."""
    reached = np.unique(last_kmers)
    frontier = reached
    while frontier.size:
        cand = neighbors_codes(frontier, k, -direction)
        keep = _in_sorted(visited, cand) & ~_in_sorted(reached, cand)
        new = np.unique(cand[keep])
        if new.size == 0:
            break
        reached = np.union1d(reached, new)
        frontier = new
    return reached


def _refuse_device_bfs() -> None:
    """The JAX package's device BFS engines (ops/bfs_dense.py,
    ops/bfs_device.py) are not ported: a request for them is an error, not
    a silent host run."""
    if (os.environ.get("MC_DEVICE_BFS") not in (None, "", "0")
            or os.environ.get("MC_DEVICE_BFS_MIN_SEEDS")):
        raise NotImplementedError(
            "device BFS engines not yet ported; unset MC_DEVICE_BFS and "
            "MC_DEVICE_BFS_MIN_SEEDS")


@dataclass
class Environment:
    """The computed environment: canonical (ASCII-lex orientation) codes + counts."""
    k: int
    codes: np.ndarray        # ascii-min oriented codes, sorted by code
    counts: np.ndarray       # int32 counts from the reads map
    fail: bool = False
    extend_count: int = 0    # log-parity value from the extendEnvironment no-op

    def normalized_strings(self) -> list[str]:
        from ..dna import codes_to_kmers_np
        return codes_to_kmers_np(self.codes, self.k)

    def as_dict(self) -> dict[str, int]:
        return dict(zip(self.normalized_strings(), self.counts.tolist()))


def seed_codes_of_sequences(seqs: list[str], k: int, kmap: KmerMap,
                            min_occ: int) -> list[int]:
    """Oriented seed codes: every k-window of every sequence whose canonical
    count >= min_occ, in order (runBfs seed loop, OneSequenceCalculator.java:159-196)."""
    from ..dna import kmer_to_code, CHAR_TO_CODE
    out: list[int] = []
    mask = (1 << (2 * k)) - 1
    for seq in seqs:
        if len(seq) < k:
            continue
        code = kmer_to_code(seq[:k])
        codes = [code]
        for i in range(1, len(seq) - k + 1):
            code = ((code << 2) | int(CHAR_TO_CODE[ord(seq[i + k - 1])])) & mask
            codes.append(code)
        arr = np.array(codes, np.int64)
        occ = kmap.get_many(canonical_codes(arr, k))
        out.extend(arr[occ >= min_occ].tolist())
    return out


def build_environment(sequences: list[str], k: int, kmap: KmerMap,
                      min_occ: int, both_directions: bool,
                      max_radius: int | None, max_kmers: int | None,
                      trim: bool, hic_sequences: list[str] | None = None) -> Environment:
    """Full environment per OneSequenceCalculator.buildEnvironment + printEnvironment.

    sequences: gene sequences (1 for single mode, N for merged mode);
    hic_sequences: extra seed sequences in merged mode (runBfs:181-191).
    """
    _refuse_device_bfs()
    seeds = seed_codes_of_sequences(
        list(sequences) + list(hic_sequences or []), k, kmap, min_occ)
    dirs = [0] if both_directions else [-1, 1]
    visited_union = np.empty(0, np.int64)
    fail = True
    for direction in dirs:
        res = bfs_fifo(seeds, kmap, k, min_occ, direction,
                       max_radius, max_kmers, collect_last=trim)
        if res.fail:
            continue
        fail = False
        vis = res.visited
        if trim:
            vis = trim_paths(vis, res.last_kmers, k, direction)
        visited_union = np.union1d(visited_union, vis)
    if fail:
        return Environment(k, np.empty(0, np.int64), np.empty(0, np.int32), fail=True)

    norm = np.unique(ascii_min_orient(visited_union, k))
    counts = kmap.get_many(canonical_codes(norm, k))
    env = Environment(k, norm, counts.astype(np.int32))
    env.extend_count = _extend_environment_count(env, kmap, min_occ)
    return env


def _extend_environment_count(env: Environment, kmap: KmerMap,
                              min_occ: int) -> int:
    """Size of the reference's `additions` set: subgraph k-mers with EXACTLY one
    (of 8, counted per slot) out-of-subgraph neighbor with count >= min_occ.
    Output no-op; value only feeds the 'Extending endings by N kmers' log
    (OneSequenceCalculator.extendEnvironment:265-295)."""
    if env.codes.size == 0:
        return 0
    cand = neighbors_codes(env.codes, env.k, 0)           # (S, 8)
    canon = canonical_codes(cand, env.k)
    # one probe-table pass for coverage, then env membership ONLY where the
    # coverage filter passed (env ⊆ map, so in-env implies covered): a
    # sorted-array search over the filtered subset replaces round 4's
    # second full probe-table build+pass (~60 ms of the wiki metric)
    occs = kmap.get_many(canon)
    covered = occs >= min_occ
    env_canon = np.sort(canonical_codes(env.codes, env.k))
    q = canon[covered]
    pos = np.searchsorted(env_canon, q)
    pos = np.minimum(pos, env_canon.size - 1)
    in_sub_cov = env_canon[pos] == q
    outside = np.zeros(canon.shape, bool)
    outside[covered] = ~in_sub_cov
    return int((outside.sum(axis=1) == 1).sum())
