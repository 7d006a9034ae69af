"""FMT visualization engines: color-driven environment/component calculators.

Carried over from metacherchant_tpu/algo/fmt.py (host code; the whole-graph
contraction goes to the device under MC_DEVICE_CONTRACT, as in
algo/calculator.create_picture).

- seq_env: seed-from-sequence BFS with presence (count > 0) tests and a
  termination mode, color callback per normalized k-mer, contraction barrier =
  equal color AND equal gene flag (src/algo/SeqEnvCalculator.java:71-225)
- kmer_env: whole-connected-component flood from one k-mer that DESTRUCTIVELY
  zeroes visited k-mers in the shared map so later seeds skip emitted
  components (src/algo/KmerEnvCalculator.java:60-90); the reference's queue
  admits duplicates and a duplicate's late addToSubgraph overwrites the stored
  count with the already-zeroed value -- replicated bug-for-bug; contraction
  barrier = equal color only
- color predicates and whole-graph picture assembly live in the tools
  (src/tools/FMTVisualiser.java:225-300, FMTVisualizer.java:195-316,
  RecipientVisualiser.java:157-222)
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np

from ..kmer_map import KmerMap
from ..dna import normalize
from ..ops.kmers import hash_str, keys_of_kmer_strings
from .contraction import (build_node_graph, do_merge, Node,
                          use_device_contraction)
from ..io.writers import write_gfa, _ensure_dir

_NUCS = "AGCT"


def _all_neighbors(kmer: str) -> list[str]:
    out = []
    for n in _NUCS:
        out.append(n + kmer[:-1])
        out.append(kmer[1:] + n)
    return out


def kmer_key(s: str, k: int, hasher: str | None) -> int:
    """Map key of a k-mer string (getKmerKey): ops.kmers.hash_str."""
    return hash_str(s, hasher)


class MutableKmerView:
    """Mutable count overlay over a KmerMap (for the destructive flood)."""

    def __init__(self, kmap: KmerMap):
        self.keys = kmap.keys
        self.counts = kmap.counts.copy()

    def get(self, key: int) -> int:
        if self.keys.size == 0:
            return -1
        pos = int(np.searchsorted(self.keys, key))
        if pos < self.keys.size and self.keys[pos] == key:
            return int(self.counts[pos])
        return -1

    def zero(self, key: int) -> None:
        pos = int(np.searchsorted(self.keys, key))
        if pos < self.keys.size and self.keys[pos] == key:
            self.counts[pos] = 0


def seq_env_subgraph(sequence: str, k: int, kmap: KmerMap, hasher: str | None,
                     max_radius: int | None, max_kmers: int | None
                     ) -> dict[str, int] | None:
    """SeqEnvCalculator.runBfs (:71-104): presence > 0, bidirectional FIFO,
    termination mode; returns normalized kmer -> count, or None on no seeds.

    Presence 'getWithZero(key) > 0' == count >= 1, so the exact-regime path
    reuses the vectorized engine with min_occ=1 when no MAX_KMERS cap is set.
    """
    if hasher is None and max_kmers is None:
        from .environment import build_environment
        env = build_environment([sequence], k, kmap, 1, True, max_radius,
                                None, False)
        if env.fail:
            return None
        return env.as_dict()
    # sequential FIFO over strings (cap-bounded or hashed regime)
    def occ(s):
        return max(kmap.get(kmer_key(s, k, hasher)), 0)
    dist: dict[str, int] = {}
    queue: list[str] = []
    for i in range(len(sequence) - k + 1):
        w = sequence[i:i + k]
        if occ(w) > 0:
            dist.setdefault(w, 0)
            queue.append(w)
    if not queue:
        return None
    head = 0
    while head < len(queue):
        cur = queue[head]
        head += 1
        d = dist[cur] + 1
        for nb in _all_neighbors(cur):
            if occ(nb) > 0:
                allowed = nb not in dist
                if allowed and max_kmers is not None and len(dist) >= max_kmers:
                    allowed = False
                if allowed and max_radius is not None and d > max_radius:
                    allowed = False
                if allowed:
                    dist[nb] = d
                    queue.append(nb)
    return {normalize(s): occ(s) for s in dist}


def kmer_env_subgraph(seed_kmer: str, k: int, graph: MutableKmerView,
                      hasher: str | None) -> dict[str, int]:
    """KmerEnvCalculator.runBfs (:60-90), bug-for-bug: FIFO with duplicate
    admissions; each processed entry records graph.get (0 for duplicates,
    overwriting the real count) then zeroes the key."""
    subgraph: dict[str, int] = {}
    queue = [seed_kmer]
    head = 0
    while head < len(queue):
        cur = queue[head]
        head += 1
        key = kmer_key(cur, k, hasher)
        for nb in _all_neighbors(cur):
            if graph.get(kmer_key(nb, k, hasher)) > 0:
                queue.append(nb)
        subgraph[normalize(cur)] = graph.get(key)  # raw get, as the reference
        graph.zero(key)
    return subgraph


def build_colored_picture(subgraph: dict[str, int], k: int,
                          color_of: Callable[[str], str | None],
                          output_prefix: str, name: str,
                          gene_sequence: str | None = None,
                          merge_on_gene: bool = False,
                          seq_id_mode: str = "own") -> list[Node]:
    """Common picture assembly for the FMT family: nodes with colors (+ gene
    flags for seq_env), color-barrier merge, <name>_seqs.fasta + <name>.gfa."""
    gene_windows: set[str] = set()
    if gene_sequence is not None:
        for i in range(len(gene_sequence) - k + 1):
            gene_windows.add(gene_sequence[i:i + k])

    def is_gene(seq: str, rc: str) -> bool:
        return seq in gene_windows or rc in gene_windows

    kmer_list = sorted(subgraph)
    # batch the color predicate: one vectorized probe per bin instead of
    # per-k-mer Python hashing + binary searches (the FMTVisualiser scale
    # case colors the entire metagenome graph, FMTVisualiser.java:287-300)
    if isinstance(color_of, MembershipColor) and kmer_list:
        lut = dict(zip(kmer_list, color_of.colors_for(kmer_list)))
        color_of = lambda s: str(lut[s])  # noqa: E731

    if use_device_contraction(len(kmer_list), k):
        # whole-metagenome pictures are the scale case: pointer-jumping
        # contraction on the device (ops/contraction_device.py)
        from ..ops.contraction_device import contract_device

        def tag_of(seq: str, rc: str):
            c = color_of(seq)
            if merge_on_gene:
                return (c, is_gene(seq, rc))
            return c

        def decorate(node, tag):
            if isinstance(tag, tuple):
                node.color, node.is_gene = tag
            else:
                node.color = tag

        nodes = contract_device(kmer_list, k, tag_of=tag_of,
                                decorate=decorate)
    else:
        nodes = build_node_graph(
            kmer_list, k,
            is_gene=is_gene if gene_sequence is not None else None,
            color_of=color_of)
        if merge_on_gene:
            do_merge(nodes, k, tag=lambda n: (n.color, n.is_gene))
        else:
            do_merge(nodes, k, tag=lambda n: n.color)
    _write_named_seqs(os.path.join(output_prefix, f"{name}_seqs.fasta"),
                      nodes, seq_id_mode)
    write_gfa(os.path.join(output_prefix, f"{name}.gfa"), nodes, k, subgraph)
    return nodes


def _write_named_seqs(path: str, nodes: list[Node], id_mode: str) -> None:
    """outputNodeSequences variants: SeqEnv uses min-id + _start
    (SeqEnvCalculator.java:262-296); FMTVisualiser/KmerEnv use the node's own
    id+1 with no suffix (FMTVisualiser.java:385-409)."""
    _ensure_dir(path)
    with open(path, "w") as out:
        for n in nodes:
            if n.deleted or n.id >= n.rc.id or len(n.seq) < 1:
                continue
            if id_mode == "min":
                label = f"{n.min_id() + 1}{'_start' if n.is_gene else ''}"
            else:
                label = str(n.id + 1)
            ids = {nb.min_id() + 1 for nb in n.neighbors}
            ids |= {nb.min_id() + 1 for nb in n.rc.neighbors}
            ids.discard(n.min_id() + 1)
            out.write(f"> Id{label} Length:{len(n.seq)} "
                      f"Neighbors:[{', '.join(map(str, sorted(ids)))}]\n")
            out.write(n.seq + "\n")


# ---------------------------------------------------------------------------
# color predicates (two-set and four-set membership rules)
# ---------------------------------------------------------------------------

class MembershipColor:
    """Bin-membership color predicate, callable per k-mer AND batchable.

    The scalar __call__ keeps the reference's per-k-mer decision shape
    (FMTVisualiser.java:225-229, 271-282); colors_for() evaluates the same
    predicate for a whole k-mer list with ONE vectorized key computation and
    ONE KmerMap.get_many probe per bin -- the path the whole-metagenome
    pictures take (FMTVisualiser.java:287-300 colors every graph k-mer)."""

    def __init__(self, k: int, hasher: str | None, bins: list[KmerMap],
                 rule_np: Callable[..., np.ndarray]):
        self.k = k
        self.hasher = hasher
        self.bins = bins
        self.rule_np = rule_np

    def __call__(self, seq: str) -> str:
        key = kmer_key(seq, self.k, self.hasher)
        member = [np.array([b.get(key) >= 0]) for b in self.bins]
        return str(self.rule_np(*member)[0])

    def colors_for(self, kmers: list[str]) -> np.ndarray:
        keys = keys_of_kmer_strings(kmers, self.k, self.hasher)
        member = [b.get_many(keys) >= 0 for b in self.bins]
        return self.rule_np(*member)


def two_bin_color(k: int, hasher: str | None, pos: KmerMap, neg: KmerMap
                  ) -> MembershipColor:
    """GREEN / BLUE / GREY / BLACK by membership in (pos, neg)
    (FMTVisualiser.java:225-229, 245-249)."""
    def rule(in_pos: np.ndarray, in_neg: np.ndarray) -> np.ndarray:
        return np.select(
            [in_pos & ~in_neg, in_neg & ~in_pos, in_pos & in_neg],
            ["GREEN", "BLUE", "GREY"], default="BLACK")
    return MembershipColor(k, hasher, [pos, neg], rule)


def four_bin_color(k: int, hasher: str | None, from_donor: KmerMap,
                   from_before: KmerMap, from_both: KmerMap, itself: KmerMap
                   ) -> MembershipColor:
    """RED/BLUE/GREEN/YELLOW exclusive, BLACK none, GREY mixed
    (FMTVisualiser.java:271-282)."""
    def rule(a, b, c, d) -> np.ndarray:
        none = ~(a | b | c | d)
        return np.select(
            [a & ~b & ~c & ~d, b & ~a & ~c & ~d,
             c & ~a & ~b & ~d, d & ~a & ~b & ~c, none],
            ["RED", "BLUE", "GREEN", "YELLOW", "BLACK"], default="GREY")
    return MembershipColor(k, hasher, [from_donor, from_before, from_both,
                                       itself], rule)
