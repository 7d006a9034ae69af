"""Unitig contraction over the doubled-node (k-mer, revcomp) graph.

Carried over from metacherchant_tpu/algo/contraction.py (host; the device
contraction is ops/contraction_device.py, routed by use_device_contraction).
Faithful reimplementation of the reference's node model and merge loop
(src/algo/OneSequenceCalculator.java:312-324 mergeNodes, :387-419
initializeStructures, :434-451 doMerge; node model src/algo/SingleNode.java):

- every canonical k-mer spawns a node pair (seq, revcomp) with mutual rc
  pointers and ids 2i / 2i+1
- adjacency: for node X with suffix s = X.seq[1:], X.rc.neighbors += all nodes
  whose (k-1)-prefix equals s; the rc-pair of the same overlap inserts the
  symmetric entry, so A in B.neighbors <=> B in A.neighbors
- merge step: node n with exactly one neighbor m, m with exactly one neighbor,
  and equal merge tag (isGeneNode; FMT adds color,
  src/algo/SeqEnvCalculator.java:208-225): concatenate sequences with k-1
  overlap onto the surviving rc pair, delete n and m
- deleted nodes are never referenced by surviving single-neighbor nodes
  (invariant of the symmetric adjacency), and writers skip deleted nodes

Node ids are assigned from the iteration order of the subgraph map; the Java
HashMap order is JVM-dependent, so ids are NOT stable reference targets
(SURVEY §7.3); we iterate keys in sorted order for run-to-run determinism.
Golden comparisons are content-based (sequence sets / topology), not id-based.
"""
from __future__ import annotations

from typing import Callable, Hashable, Iterable

from ..dna import reverse_complement

_GC_LOCK = __import__("threading").Lock()
_GC_DEPTH = 0
_GC_WAS_ENABLED = False


class _gc_suspended:
    """Refcounted, thread-safe cyclic-GC suspension.

    Creating hundreds of thousands of mutually-referencing Nodes triggers
    repeated full collections that find nothing (~40% of build time at
    400K k-mers). A bare disable()/enable() pair would race under the
    per-gene thread pool (the first thread to finish would re-enable GC
    mid-build for its siblings), so suspension is depth-counted: GC is
    re-enabled only when the LAST suspender exits, and only if it was
    enabled on first entry."""

    def __enter__(self):
        import gc
        global _GC_DEPTH, _GC_WAS_ENABLED
        with _GC_LOCK:
            if _GC_DEPTH == 0:
                _GC_WAS_ENABLED = gc.isenabled()
                if _GC_WAS_ENABLED:
                    gc.disable()
            _GC_DEPTH += 1
        return self

    def __exit__(self, *exc):
        import gc
        global _GC_DEPTH
        with _GC_LOCK:
            _GC_DEPTH -= 1
            if _GC_DEPTH == 0 and _GC_WAS_ENABLED:
                gc.enable()
        return False


class Node:
    __slots__ = ("seq", "id", "rc", "neighbors", "deleted", "is_gene", "color",
                 "graphs")

    def __init__(self, seq: str, node_id: int, is_gene: bool = False,
                 color: str | None = None, graphs: frozenset | None = None):
        self.seq = seq
        self.id = node_id
        self.rc: "Node" = None  # type: ignore
        self.neighbors: list["Node"] = []
        self.deleted = False
        self.is_gene = is_gene
        self.color = color  # GFA CL tag: GREEN for gene nodes, or FMT colors
        self.graphs = graphs  # environment-finder-multi's membership set

    def min_id(self) -> int:
        return min(self.id, self.rc.id)


def build_node_graph(kmers: Iterable[str], k: int,
                     is_gene: Callable[[str, str], bool] | None = None,
                     color_of: Callable[[str], str | None] | None = None,
                     graphs_of: Callable[[str], frozenset] | None = None
                     ) -> list[Node]:
    """initializeStructures (OneSequenceCalculator.java:387-419): two nodes per
    canonical k-mer + (k-1)-prefix index adjacency. `kmers` iteration order
    defines ids. Colors come from color_of when given, else GREEN for gene
    nodes; membership sets from graphs_of when given, else None."""
    kmer_list = kmers if isinstance(kmers, list) else list(kmers)
    n = len(kmer_list)
    rcs = _bulk_reverse_complement(kmer_list, k)
    # per-kmer attribute lists first (bulk comprehensions), then one tight
    # construction loop -- the per-node Python work is the remaining hot
    # slice of genome-scale pictures after the vectorized linking. GC is
    # suspended across the bulk allocation (see _gc_suspended).
    with _gc_suspended():
        genes = ([bool(is_gene(s, r)) for s, r in zip(kmer_list, rcs)]
                 if is_gene else [False] * n)
        colors = ([color_of(s) for s in kmer_list] if color_of
                  else ["GREEN" if g else None for g in genes])
        graphss = ([graphs_of(s) for s in kmer_list] if graphs_of
                   else [None] * n)
        nodes: list[Node] = []
        append = nodes.append
        nid = 0
        for seq, rc, gene, color, graphs in zip(kmer_list, rcs, genes,
                                                colors, graphss):
            a = Node(seq, nid, gene, color, graphs)
            b = Node(rc, nid + 1, gene, color, graphs)
            a.rc = b
            b.rc = a
            append(a)
            append(b)
            nid += 2
        _link_adjacency(nodes, kmer_list, rcs, k)
    return nodes


def _link_adjacency(nodes: list[Node], kmer_list: list[str],
                    rcs: list[str], k: int) -> None:
    """Prefix/suffix adjacency in bulk: pack every node's (k-1)-prefix and
    (k-1)-suffix as integer codes and match with one argsort + two
    searchsorted passes instead of a per-node string-slice dict (the
    dominant build cost at genome scale: ~1 s of per-slice hashing at 100K
    k-mers, VERDICT r4 weak #6). Neighbor lists keep the exact semantics
    and ORDER of the by_prefix dict (ascending node id within each prefix
    group -- the stable argsort preserves it). Falls back to the dict path
    when codes cannot be packed (non-ACGT or k-1 > 31)."""
    import numpy as np
    n2 = len(nodes)
    if n2 == 0:
        return
    # every length checked individually: a ragged list whose total happens
    # to equal half*k must not reshape (same trap as ADVICE r4 on the bulk
    # revcomp)
    if k - 1 > 31 or any(len(s) != k for s in kmer_list):
        _link_adjacency_dict(nodes, k)
        return
    try:
        joined = "".join(kmer_list) + "".join(rcs)
        arr = np.frombuffer(joined.encode("ascii"), np.uint8)
    except ValueError:  # non-ASCII: the dict path handles any strings
        _link_adjacency_dict(nodes, k)
        return
    lut = np.full(256, 255, np.uint8)
    for ch, v in zip(b"AGCT", range(4)):
        lut[ch] = v
    codes = lut[arr]
    if codes.max() > 3:
        _link_adjacency_dict(nodes, k)  # IUPAC leftovers: dict oracle
        return
    # rows: kmer_list rows then rc rows; node order is interleaved (2i, 2i+1)
    half = len(kmer_list)
    mat = codes.reshape(2, half, k)
    inter = np.empty((n2, k), np.uint8)
    inter[0::2] = mat[0]
    inter[1::2] = mat[1]
    pw = (np.int64(1) << (2 * np.arange(k - 2, -1, -1, dtype=np.int64)))
    prefix = inter[:, : k - 1].astype(np.int64) @ pw
    suffix = inter[:, 1:].astype(np.int64) @ pw
    order = np.argsort(prefix, kind="stable")
    sp = prefix[order]
    lo = np.searchsorted(sp, suffix, side="left")
    hi = np.searchsorted(sp, suffix, side="right")
    has = np.flatnonzero(hi > lo)
    ordered = [nodes[j] for j in order]  # list-slice extends are C-speed
    lo_l, hi_l = lo.tolist(), hi.tolist()
    for i in has.tolist():
        nodes[i].rc.neighbors.extend(ordered[lo_l[i]:hi_l[i]])


def _link_adjacency_dict(nodes: list[Node], k: int) -> None:
    """The original by-prefix dict linking (initializeStructures,
    OneSequenceCalculator.java:387-419); oracle for the packed path."""
    by_prefix: dict[str, list[Node]] = {}
    for n in nodes:
        by_prefix.setdefault(n.seq[: k - 1], []).append(n)
    for n in nodes:
        suffix = n.seq[1:]
        hit = by_prefix.get(suffix)
        if hit:
            n.rc.neighbors.extend(hit)


def _bulk_reverse_complement(kmer_list: list[str], k: int) -> list[str]:
    """Reverse-complement a whole k-mer list in one numpy pass (identical to
    per-string reverse_complement; order preserved). Falls back to the
    scalar path for ragged/empty input."""
    import numpy as np
    n = len(kmer_list)
    # validate EVERY length, not just the first: a ragged list whose total
    # character count happens to equal n*k would reshape "successfully" and
    # silently return wrong results (ADVICE r4)
    if n == 0 or any(len(s) != k for s in kmer_list):
        return [reverse_complement(s) for s in kmer_list]
    try:
        arr = np.frombuffer("".join(kmer_list).encode("ascii"),
                            np.uint8).reshape(n, k)
    except ValueError:  # non-ASCII input (UnicodeEncodeError is a ValueError)
        return [reverse_complement(s) for s in kmer_list]
    lut = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGTacgt", b"TGCATGCA"):
        lut[a] = b
    if not np.all(lut[arr] > 0):  # non-ACGT character: scalar oracle
        return [reverse_complement(s) for s in kmer_list]
    big = lut[arr][:, ::-1].tobytes().decode("ascii")
    return [big[i:i + k] for i in range(0, n * k, k)]


def _default_tag(n: Node) -> Hashable:
    return n.is_gene


def merge_nodes(first_plus: Node, second_minus: Node, k: int) -> None:
    """mergeNodes (OneSequenceCalculator.java:312-324)."""
    first_minus, second_plus = first_plus.rc, second_minus.rc
    assert second_plus.seq[-(k - 1):] == first_plus.seq[: k - 1], \
        "Labels should be merged, but can not"  # checkLabels (:445-449)
    new_seq = second_plus.seq + first_plus.seq[k - 1:]
    new_seq_rc = first_minus.seq + second_minus.seq[k - 1:]
    second_plus.seq = new_seq
    first_minus.seq = new_seq_rc
    second_plus.rc = first_minus
    first_minus.rc = second_plus
    first_plus.deleted = second_minus.deleted = True


def do_merge(nodes: list[Node], k: int,
             tag: Callable[[Node], Hashable] = _default_tag) -> None:
    """doMerge exactly as written (OneSequenceCalculator.java:434-451):
    full sweeps to fixpoint, ascending node order.

    NOTE kept deliberately order-faithful: in degenerate configurations
    (self-adjacent homopolymer k-mers, palindromic overlaps, parallel edges)
    the merged content depends on processing order -- the reference does not
    even check `other.deleted` before merging -- so a worklist reformulation
    produces different (equally arbitrary) unitig sets. An experiment
    confirming the divergence lives in tests/test_contraction.py.

    The sweep iterates a PRE-FILTERED candidate list instead of all nodes:
    merge_nodes never mutates neighbor lists or neighbor membership (only
    `deleted`, `seq` and the rc pairing), so a node's eligibility --
    len(n.neighbors) == 1 and len(other.neighbors) == 1 and tag equality
    -- is TIME-INVARIANT, and the reference loop visits exactly the
    candidates in ascending order with only the dynamic n.deleted check.
    The filtered loop therefore performs the identical merge_nodes
    sequence (pinned node-for-node against the literal reference sweep in
    tests/test_contraction.py, including degenerate graphs and the
    fmt/multi tag shapes) at O(candidates) per sweep.

    CONTRACT: `tag` must read only merge-invariant attributes (is_gene,
    color -- as every caller does). A tag reading `seq`, `rc` or `deleted`
    would be re-evaluated at visit time by the reference loop but is frozen
    at entry here. Under this contract every live candidate merges on its
    first visit, so the while-loop settles after one acting sweep plus one
    empty confirmation sweep (the reference's fixpoint structure, kept
    verbatim)."""
    candidates = [n for n in nodes
                  if len(n.neighbors) == 1
                  and len(n.neighbors[0].neighbors) == 1
                  and tag(n) == tag(n.neighbors[0])]
    # suspend the cyclic GC across the merge storm (string churn triggers
    # full collections that find nothing among the long-lived
    # mutually-referencing nodes; see _gc_suspended)
    with _gc_suspended():
        while True:
            acted = False
            for n in candidates:
                if n.deleted:
                    continue
                merge_nodes(n, n.neighbors[0], k)
                acted = True
            if not acted:
                return


def alive(nodes: list[Node]) -> list[Node]:
    return [n for n in nodes if not n.deleted]


def gene_kmer_checker(gene_seqs: list[str], k: int) -> Callable[[str, str], bool]:
    """isGeneNode (OneSequenceCalculator.java:421-432): the gene sequence
    contains the k-mer or its rc as a substring. At graph-build time node
    sequences are exactly k long, so containment == window membership."""
    windows: set[str] = set()
    for s in gene_seqs:
        for i in range(len(s) - k + 1):
            windows.add(s[i:i + k])
    def check(seq: str, rc: str) -> bool:
        return seq in windows or rc in windows
    return check


def use_device_contraction(n_kmers: int, k: int) -> bool:
    """Device-contraction routing of the per-gene and FMT pictures, as the
    JAX package routes: MC_DEVICE_CONTRACT=1 forces the device route and
    "0" the host sweep; otherwise MC_DEVICE_CONTRACT_MIN, when set, routes
    pictures of at least that many k-mers to the device. Only odd k <= 31
    is eligible; every other value of the switch takes the host sweep."""
    import os
    flag = os.environ.get("MC_DEVICE_CONTRACT")
    eligible = k % 2 == 1 and k <= 31
    auto_min_env = os.environ.get("MC_DEVICE_CONTRACT_MIN")
    auto_min = int(auto_min_env) if auto_min_env else None
    return eligible and (
        flag == "1" or (flag != "0" and auto_min is not None
                        and n_kmers >= auto_min))
