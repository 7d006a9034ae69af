"""Hashed-regime (k > 31 / --forcehash) environment BFS.

Carried over from metacherchant_tpu/algo/environment_hashed.py. The
reference's BFS always walks literal k-mer strings; in the hashed regime only
the MAP KEY changes (64-bit canonical hash instead of the 2-bit code,
src/algo/OneSequenceCalculator.java:89-96 getKmerKey). Arbitrary k cannot pack
into one int64, so states here are (k,) nucleotide-code rows. Three host
engines, each in the reference's exact FIFO order -- (parent admission order,
neighbor order) -- so order-dependent semantics (MAX_KMERS at admission time,
lastKmers marking, TerminationMode.java:31-47) match the Java run:

- the native C++ FIFO (native/bfs.cpp, both hashes), the default;
- where the native library is not built (no g++, or MC_NATIVE_BFS=0), for
  the poly hash a scalar FIFO that slides each state's (fw, rc) hash pair
  in O(1) per neighbor (_bfs_scalar_poly);
- in that case for FNV-1a, which has no sliding form, a layer-synchronous
  FIFO that hashes each layer's candidates as one batch
  (ops.kmers.hash_codes_np, exact Java wrap) and admits them sequentially
  (_bfs_layer_fifo).

getKmerKey(s) = hasher.hash(normalizeDna(s)) == hasher.hash(s): both poly and
FNV-1a hashes are orientation-invariant (min of fw/rc), so normalization
before hashing is redundant -- replicated here by hashing the state directly.

Under MC_DEVICE_BFS (routing as the exact regime's, route_device_bfs) the
multiword device engine ops/bfs_hashed.py runs instead, on the device of
device.py; radius-only termination gives the FIFO's visited set.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from ..kmer_map import KmerMap
from ..dna import CODE_TO_CHAR, encode
from ..ops.kmers import hash_codes_np, hash_codes_pair_np
from .environment import Environment, route_device_bfs

logger = logging.getLogger("metacherchant")

_NUCS = "AGCT"  # neighbor generation order (itmo:dna/DnaTools.java:33)

# code -> ASCII rank (A=0,G=1,C=2,T=3 codes; ASCII order A<C<G<T)
_ASCII_RANK = np.array([0, 2, 1, 3], np.uint8)


def _native_bfs_available() -> bool:
    from .. import native
    return native.bfs_available()


def _neighbor_block(states: np.ndarray, direction: int) -> np.ndarray:
    """(F, k) states -> (F, D, k) neighbor states in reference order.

    StringUtils left/right/all neighbors (src/utils/StringUtils.java:8-32):
    left = n + s[:-1], right = s[1:] + n for n in AGCT; direction 0
    interleaves (l_n, r_n) per nucleotide.
    """
    F, k = states.shape
    nucs = np.arange(4, dtype=np.uint8)
    left = np.empty((F, 4, k), np.uint8)
    right = np.empty((F, 4, k), np.uint8)
    left[:, :, 0] = nucs[None, :]
    left[:, :, 1:] = states[:, None, :-1]
    right[:, :, :-1] = states[:, None, 1:]
    right[:, :, -1] = nucs[None, :]
    if direction == -1:
        return left
    if direction == 1:
        return right
    out = np.empty((F, 8, k), np.uint8)
    out[:, 0::2] = left
    out[:, 1::2] = right
    return out


def _occ_block(kmap: KmerMap, states: np.ndarray, hasher: str) -> np.ndarray:
    """Vectorized coverage of (N, k) states (absent -> -1)."""
    if states.shape[0] == 0:
        return np.empty(0, np.int32)
    return kmap.get_many(hash_codes_np(states, hasher))


def _revcomp_rows(states: np.ndarray) -> np.ndarray:
    """(N, k) -> reverse complement rows (complement = 3 - code = code ^ 3)."""
    return (3 - states[:, ::-1]).astype(np.uint8)


def _normalize_rows(states: np.ndarray) -> np.ndarray:
    """Row-wise ASCII-lexicographic min(s, rc(s))
    (src/utils/StringUtils.java:34-41; ASCII order A<C<G<T)."""
    rc = _revcomp_rows(states)
    ra, rb = _ASCII_RANK[states], _ASCII_RANK[rc]
    diff = ra != rb
    any_diff = diff.any(axis=1)
    first = np.where(any_diff, diff.argmax(axis=1), 0)
    rows = np.arange(states.shape[0])
    take_rc = any_diff & (rb[rows, first] < ra[rows, first])
    return np.where(take_rc[:, None], rc, states)


def _rows_to_strings(states: np.ndarray) -> list[str]:
    chars = CODE_TO_CHAR[states.astype(np.int64)]
    return chars.tobytes().decode("ascii") if states.ndim == 1 else [
        row.tobytes().decode("ascii") for row in chars]


def build_environment_hashed(sequences: list[str], k: int, kmap: KmerMap,
                             min_occ: int, hasher: str,
                             both_directions: bool, max_radius: int | None,
                             max_kmers: int | None, trim: bool,
                             hic_sequences: list[str] | None = None) -> Environment:
    # Seeds: every k-window of every input sequence with count >= min_occ,
    # in order (runBfs seed loop, OneSequenceCalculator.java:159-196).
    seed_rows: list[np.ndarray] = []
    for seq in list(sequences) + list(hic_sequences or []):
        if len(seq) < k:
            continue
        codes = encode(seq)
        wins = np.lib.stride_tricks.sliding_window_view(codes, k).astype(np.uint8)
        occ = _occ_block(kmap, wins, hasher)
        seed_rows.extend(wins[occ >= min_occ])
    dirs = [0] if both_directions else [-1, 1]
    use_device = route_device_bfs(len(seed_rows), max_radius, max_kmers, trim)
    union: dict[bytes, np.ndarray] = {}
    fail = True
    for direction in dirs:
        if not seed_rows:
            continue
        fail = False
        t0 = time.perf_counter()
        n_before = len(union)
        if use_device:
            engine = "multiword device"
            from ..device import device
            from ..ops.bfs_hashed import run_device_bfs_hashed
            rows = run_device_bfs_hashed(np.stack(seed_rows), kmap, k,
                                         min_occ, hasher, direction,
                                         max_radius, device=device())
            union.update({row.tobytes(): row for row in rows})
        elif _native_bfs_available():
            # C++ FIFO engine (native/bfs.cpp): exact admission semantics for
            # BOTH hash regimes (incl. FNV-1a, which has no sliding form)
            engine = "native FIFO"
            from .. import native
            vis_rows, last_rows = native.bfs_hashed(
                kmap.keys, kmap.counts, np.stack(seed_rows), k, min_occ,
                direction, max_radius, max_kmers, hasher, collect_last=trim)
            rows = {row.tobytes(): row for row in vis_rows}
            if trim:
                keep = _trim(rows, {r.tobytes() for r in last_rows}, direction)
                rows = {b: rows[b] for b in keep}
            union.update(rows)
        elif hasher == "poly":
            # scalar FIFO with O(1) sliding (fw, rc) hash updates -- 5 is odd,
            # hence invertible mod 2^64, so both left and right extensions
            # slide
            engine = "scalar sliding-poly FIFO"
            union.update(_bfs_scalar_poly(seed_rows, kmap, k, min_occ,
                                          direction, max_radius, max_kmers,
                                          trim))
        else:
            engine = "layer FIFO"
            union.update(_bfs_layer_fifo(seed_rows, kmap, k, min_occ, hasher,
                                         direction, max_radius, max_kmers,
                                         trim))
        logger.debug("%s BFS, direction %d: union of %d states after %d, "
                     "%.3f s", engine, direction, len(union), n_before,
                     time.perf_counter() - t0)
    if fail:
        return Environment(k, np.empty(0, np.int64), np.empty(0, np.int32), fail=True)

    states = np.stack(list(union.values())) if union else np.empty((0, k), np.uint8)
    env = _HashedEnvironment(k, states, kmap, hasher)
    env.extend_count = _extend_count(states, env._norm_set, kmap, hasher, min_occ)
    return env


def _bfs_scalar_poly(seed_rows: list[np.ndarray], kmap: KmerMap, k: int,
                     min_occ: int, direction: int, max_radius: int | None,
                     max_kmers: int | None, trim: bool
                     ) -> dict[bytes, np.ndarray]:
    """One runBfs pass, scalar FIFO, polynomial hash regime.

    Queue entries carry (state bytes, fw, rc) where fw/rc are the unsigned
    bit patterns of the Java hashes. With p = 5^k, q = 5^(k-1) (mod 2^64):
        fw(s) = p + sum_t  s[t]      * 5^(k-1-t)
        rc(s) = p + sum_u (3^s[u])   * 5^u
    Right extension s[1:]+n:  fw' = 5*fw - 4p - s[0]*p + n
                              rc' = (rc - p - (3^s[0]))*inv5 + (3^n)*q + p
    Left extension  n+s[:-1]: fw' = (fw - p - s[-1])*inv5 + n*q + p
                              rc' = (rc - p - (3^s[-1])*q)*5 + p + (3^n)
    Key = signed min(fw', rc'), probed in a Python dict of the whole map,
    built once and cached on the map as kmap._hash_dict. Duplicate seeds are
    queued as the reference queues them; admission (MAX_KMERS at admission
    time, then the radius) and lastKmers marking as in _bfs_layer_fifo, in
    the same FIFO order.
    """
    MASK = (1 << 64) - 1
    inv5 = pow(5, -1, 1 << 64)
    p = pow(5, k, 1 << 64)
    q = pow(5, k - 1, 1 << 64)
    counts = getattr(kmap, "_hash_dict", None)
    if counts is None:
        t0 = time.perf_counter()
        counts = dict(zip(kmap.keys.tolist(), kmap.counts.tolist()))
        kmap._hash_dict = counts
        logger.debug("scalar sliding-poly FIFO: key dict of %d map entries "
                     "built in %.3f s", len(counts), time.perf_counter() - t0)
    get = counts.get
    TWO63, TWO64 = 1 << 63, 1 << 64

    dist: dict[bytes, int] = {}
    queue: list[tuple[bytes, int, int]] = []
    if seed_rows:
        fw_a, rc_a = hash_codes_pair_np(np.stack(seed_rows), "poly")
        for row, fw, rc in zip(seed_rows, fw_a.tolist(), rc_a.tolist()):
            b = row.tobytes()
            if b not in dist:
                dist[b] = 0
            queue.append((b, fw, rc))
    last: set[bytes] = set()
    head = 0
    while head < len(queue):
        s, fw, rc = queue[head]
        head += 1
        dd = dist[s] + 1
        if direction != 1:
            cl = s[-1]
            bfL = ((fw - p - cl) * inv5) & MASK
            brL = ((rc - p - (cl ^ 3) * q) * 5) & MASK
            pre = s[:-1]
            lefts = [(bytes((n,)) + pre, (bfL + n * q + p) & MASK,
                      (brL + p + (n ^ 3)) & MASK) for n in range(4)]
        if direction != -1:
            c0 = s[0]
            bfR = (5 * fw - 4 * p - c0 * p) & MASK
            brR = ((rc - p - (c0 ^ 3)) * inv5) & MASK
            suf = s[1:]
            rights = [(suf + bytes((n,)), (bfR + n) & MASK,
                       (brR + (n ^ 3) * q + p) & MASK) for n in range(4)]
        if direction == -1:
            nbrs = lefts
        elif direction == 1:
            nbrs = rights
        else:  # interleaved L0,R0,L1,R1,... (StringUtils.allNeighbors:24-32)
            nbrs = [x for pair in zip(lefts, rights) for x in pair]
        for nb, nfw, nrc in nbrs:
            sfw = nfw - TWO64 if nfw >= TWO63 else nfw
            src = nrc - TWO64 if nrc >= TWO63 else nrc
            oc = get(sfw if sfw < src else src)
            if oc is not None and oc >= min_occ:
                allowed = nb not in dist
                if allowed and max_kmers is not None and len(dist) >= max_kmers:
                    allowed = False
                if allowed and max_radius is not None and dd > max_radius:
                    allowed = False
                if allowed:
                    dist[nb] = dd
                    queue.append((nb, nfw, nrc))
                elif trim:
                    last.add(s)
    rows = {b: np.frombuffer(b, np.uint8) for b in dist}
    if trim:
        keep = _trim(rows, last, direction)
        return {b: rows[b] for b in keep}
    return rows


def _bfs_layer_fifo(seed_rows: list[np.ndarray], kmap: KmerMap, k: int,
                    min_occ: int, hasher: str, direction: int,
                    max_radius: int | None, max_kmers: int | None,
                    trim: bool) -> dict[bytes, np.ndarray]:
    """One runBfs pass (OneSequenceCalculator.java:137-262). Returns the
    visited (post-trim) oriented states keyed by their code bytes."""
    dist: dict[bytes, int] = {}
    rows: dict[bytes, np.ndarray] = {}
    # Java enqueues duplicate seeds (queue.add outside the dist check,
    # OneSequenceCalculator.java:159-192); a duplicate admits nothing new but
    # DOES mark itself as a lastKmer when its neighbors are already visited,
    # so the layer-0 frontier keeps duplicates in seed order.
    frontier: list[bytes] = []
    for row in seed_rows:
        b = row.tobytes()
        if b not in dist:
            dist[b] = 0
            rows[b] = row
        frontier.append(b)
    last: set[bytes] = set()
    d = 0
    while frontier:
        d += 1
        fmat = np.stack([rows[b] for b in frontier])
        cand = _neighbor_block(fmat, direction)          # (F, D, k)
        F, D, _ = cand.shape
        occ = _occ_block(kmap, cand.reshape(F * D, k), hasher).reshape(F, D)
        eligible = occ >= min_occ
        next_frontier: list[bytes] = []
        if max_radius is not None and d > max_radius:
            # whole layer over the radius: allowsAddition is false for every
            # eligible neighbor, so each such parent becomes a lastKmer
            if trim:
                for i in range(F):
                    if eligible[i].any():
                        last.add(frontier[i])
            break
        for i in range(F):
            parent = frontier[i]
            for j in range(D):
                if not eligible[i, j]:
                    continue
                row = cand[i, j]
                b = row.tobytes()
                allowed = b not in dist
                if allowed and max_kmers is not None and len(dist) >= max_kmers:
                    allowed = False
                if allowed:
                    dist[b] = d
                    rows[b] = row
                    next_frontier.append(b)
                elif trim:
                    last.add(parent)
        frontier = next_frontier
    if trim:
        keep = _trim(rows, last, direction)
        return {b: rows[b] for b in keep}
    return rows


def _trim(rows: dict[bytes, np.ndarray], last: set[bytes],
          direction: int) -> set[bytes]:
    """runTrimPaths (OneSequenceCalculator.java:241-262): reverse BFS from the
    blocked frontier, retain reached. Membership-only -- no hashing."""
    reached = set(last)
    queue = [b for b in last]
    head = 0
    while head < len(queue):
        cur = queue[head]
        head += 1
        cand = _neighbor_block(rows[cur][None, :], -direction)[0]
        for row in cand:
            b = row.tobytes()
            if b in rows and b not in reached:
                reached.add(b)
                queue.append(b)
    return reached


def _extend_count(states: np.ndarray, norm_set: set[bytes], kmap: KmerMap,
                  hasher: str, min_occ: int) -> int:
    """extendEnvironment no-op count (OneSequenceCalculator.java:265-295):
    nodes with exactly one out-of-subgraph eligible continuation."""
    if states.shape[0] == 0:
        return 0
    N, k = states.shape
    cand = _neighbor_block(states, 0)                    # (N, 8, k)
    occ = _occ_block(kmap, cand.reshape(N * 8, k), hasher).reshape(N, 8)
    norm = _normalize_rows(cand.reshape(N * 8, k)).reshape(N, 8, k)
    outside = np.zeros(N, np.int64)
    for j in range(8):
        in_sub = np.array([norm[i, j].tobytes() in norm_set for i in range(N)])
        outside += (~in_sub) & (occ[:, j] >= min_occ)
    return int(np.sum(outside == 1))


class _HashedEnvironment(Environment):
    """Environment whose normalized strings come from code-row states."""

    def __init__(self, k: int, states: np.ndarray, kmap: KmerMap, hasher: str):
        if states.shape[0]:
            norm = _normalize_rows(states)
            # unique rows, sorted by ASCII-lexicographic string order
            ranked = _ASCII_RANK[norm]
            order = np.lexsort(tuple(ranked[:, c] for c in range(k - 1, -1, -1)))
            norm = norm[order]
            keep = np.ones(norm.shape[0], bool)
            keep[1:] = (norm[1:] != norm[:-1]).any(axis=1)
            norm = norm[keep]
            counts = kmap.get_many(hash_codes_np(norm, hasher)).astype(np.int32)
        else:
            norm = np.empty((0, k), np.uint8)
            counts = np.empty(0, np.int32)
        super().__init__(k, np.empty(0, np.int64), counts)
        self._norm_rows = norm
        self._norm_set = {row.tobytes() for row in norm}
        self._norm_strings: list[str] | None = None

    def normalized_strings(self) -> list[str]:
        if self._norm_strings is None:
            self._norm_strings = _rows_to_strings(self._norm_rows)
        return self._norm_strings
