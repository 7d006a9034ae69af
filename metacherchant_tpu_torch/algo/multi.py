"""Differential multi-graph join (src/algo/MultiSequenceCalculator.java).

Carried over from metacherchant_tpu/algo/multi.py; the outputs must stay
byte-identical to the JAX package's.

Builds the union graph of N environments with per-node graph-membership sets,
contracts chains only where membership AND gene flags agree, and emits the
colored GFA + seqs.fasta. Structural differences vs the single-env engine,
replicated exactly:

- node set = union of k-mers of all graphs plus their reverse complements
  (initializeStructures:51-100); node pairs created on the ASCII-canonical
  orientation
- adjacency via right-successor map lookups (:90-99), same symmetric effect
- merge barrier: equal isGeneNode AND equal graphs set (canBeMerged:120-122)
- seqs.fasta has no chunkLength filter (outputNodeSequences:139-159)
- GFAWriterMulti: S lines select id < rc.id (not seq order); KC sums counts
  over ALL graphs with no (k-1) tail term; L lines do NOT skip deleted second
  endpoints; edge signs use id order; colors by |membership| with the 2/3/N
  palettes incl. the >3-graph greyscale 256*|graphs|/N with %02X overflow
  (io/writers/GFAWriterMulti.java:60-133) -- all bug-for-bug.
"""
from __future__ import annotations

import os

from ..dna import reverse_complement, normalize
from .contraction import Node, do_merge

COLOR_BLACK = "#000000"
COLOR_RED = "#ff0000"
COLOR_GREEN = "#00ff00"
COLOR_BLUE = "#0000ff"


def build_multi_node_graph(graphs: list[dict[str, int]], k: int,
                           gene_sequence: str) -> list[Node]:
    """initializeStructures (MultiSequenceCalculator.java:51-100)."""
    union: set[str] = set()
    for g in graphs:
        for kmer in g:
            union.add(kmer)
            union.add(reverse_complement(kmer))
    nodes: list[Node] = []
    by_kmer: dict[str, Node] = {}
    for kmer in sorted(union):
        rc = reverse_complement(kmer)
        if kmer > rc:
            continue
        is_gene = kmer in _windows(gene_sequence, k) or rc in _windows(gene_sequence, k)
        a = Node(kmer, len(nodes), is_gene)
        b = Node(rc, len(nodes) + 1, is_gene)
        a.rc, b.rc = b, a
        nodes.extend((a, b))
        by_kmer[a.seq] = a
        by_kmer[b.seq] = b
    for i, g in enumerate(graphs):
        for kmer in g:
            node = by_kmer[kmer]
            node.graphs = (node.graphs or frozenset()) | {i}
            node.rc.graphs = (node.rc.graphs or frozenset()) | {i}
    for n in nodes:
        for nuc in "AGCT":
            nxt = n.seq[1:] + nuc
            neighbor = by_kmer.get(nxt)
            if neighbor is not None:
                n.rc.neighbors.append(neighbor)
    return nodes


_window_cache: dict[tuple[str, int], set[str]] = {}


def _windows(seq: str, k: int) -> set[str]:
    key = (seq, k)
    if key not in _window_cache:
        _window_cache[key] = {seq[i:i + k] for i in range(len(seq) - k + 1)}
    return _window_cache[key]


def multi_merge(nodes: list[Node], k: int) -> None:
    """doMerge with the membership barrier (canBeMerged:120-122)."""
    do_merge(nodes, k, tag=lambda n: (n.is_gene, n.graphs or frozenset()))


def determine_color(node: Node, n_graphs: int) -> str:
    """GFAWriterMulti.determineColor:93-133, bug-for-bug (%02X overflow for
    256*|graphs|/N == 256)."""
    membership = len(node.graphs or ())
    if node.is_gene:
        return COLOR_GREEN
    if n_graphs == 2:
        return {1: COLOR_RED, 2: COLOR_BLUE}.get(membership, COLOR_BLACK)
    if n_graphs == 3:
        return {1: COLOR_RED, 2: COLOR_BLUE, 3: "#ff00ff", 4: "#ffff00",
                5: "#ffaa00", 6: "#00ffff"}.get(membership, COLOR_BLACK)
    value = 256 * membership // n_graphs
    return "#" + (f"{value:02X}" * 3)


def write_gfa_multi(path: str, nodes: list[Node], k: int,
                    graphs: list[dict[str, int]]) -> None:
    """GFAWriterMulti.printGraph (io/writers/GFAWriterMulti.java:39-91)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def label(n: Node) -> str:
        return f"{n.min_id() + 1}{'_start' if n.is_gene else ''}"

    with open(path, "w") as out:
        for n in nodes:
            if n.deleted or n.id >= n.rc.id:
                continue
            cov = 0
            for g in graphs:
                for i in range(len(n.seq) - k + 1):
                    cov += g.get(normalize(n.seq[i:i + k]), 0)
            color = determine_color(n, len(graphs))
            out.write(f"S\t{label(n)}\t{n.seq}\tLN:i:{len(n.seq)}\tKC:i:{cov}"
                      f"\tCL:Z:{color}\tC2:Z:{color}\n")
        for n in nodes:
            if n.deleted:
                continue
            for m in n.neighbors:
                # NOTE: reference does not skip deleted second endpoints here
                sign_a = "+" if n.id < n.rc.id else "-"
                sign_b = "+" if m.id > m.rc.id else "-"
                out.write(f"L\t{label(n)}\t{sign_a}\t{label(m)}\t{sign_b}"
                          f"\t{k - 1}M\n")


def write_seqs_fasta_multi(path: str, nodes: list[Node]) -> None:
    """outputNodeSequences (MultiSequenceCalculator.java:139-159): no length filter."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as out:
        for n in nodes:
            if n.deleted or n.id >= n.rc.id:
                continue
            ids = {nb.min_id() + 1 for nb in n.neighbors}
            ids |= {nb.min_id() + 1 for nb in n.rc.neighbors}
            ids.discard(n.min_id() + 1)
            label = f"{n.min_id() + 1}{'_start' if n.is_gene else ''}"
            out.write(f"> Id{label} Length:{len(n.seq)} "
                      f"Neighbors:[{', '.join(map(str, sorted(ids)))}]\n")
            out.write(n.seq + "\n")


def jaccard_matrices(graphs: list[dict[str, int]]) -> tuple[list[list[float]], list[list[float]]]:
    """Weighted pairwise distances (EnvironmentFinderMultiMain.printProbability
    :106-168): for each ordered pair (F, S):
      difference  += sum_{kmer in F\\S} F[kmer] + sum |F-S| over F&S + sum_{S\\F} S[kmer]
      differenceAlt += sum_{F\\S} F[kmer] + sum |F-S|
      union       += sum_{F\\S} F[kmer] + sum max(F,S) + sum_{S\\F} S[kmer]
    sym = 1 - intersection/union; alt = 1 - intersection/(union - differenceAlt)
    with intersection = union - difference."""
    n = len(graphs)
    sym = [[0.0] * n for _ in range(n)]
    alt = [[0.0] * n for _ in range(n)]
    for i, gf in enumerate(graphs):
        for j, gs in enumerate(graphs):
            difference = difference_alt = union = 0
            for kmer, cf in gf.items():
                cs = gs.get(kmer)
                if cs is None:
                    difference += cf
                    difference_alt += cf
                    union += cf
                else:
                    difference += abs(cf - cs)
                    difference_alt += abs(cf - cs)
                    union += max(cf, cs)
            for kmer, cs in gs.items():
                if kmer not in gf:
                    difference += cs
                    union += cs
            intersection = union - difference
            sym[i][j] = 1 - intersection / union if union else float("nan")
            denom = union - difference_alt
            alt[i][j] = 1 - intersection / denom if denom else float("nan")
    return sym, alt


def write_jaccard(outdir: str, env_files: list[str],
                  graphs: list[dict[str, int]]) -> None:
    """Jacard_sym.txt / Jacard_alt.txt, headers byte-identical to the reference
    (including its mangled ANSI prefix, EnvironmentFinderMultiMain.java:115-117)."""
    sym, alt = jaccard_matrices(graphs)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "Jacard_sym.txt"), "w") as out:
        out.write("The[31mWarning! symmetric <<Jaccard distance>> (1 - AB/AUB):\n\n")
        for i, f in enumerate(env_files):
            out.write(str(f))
            for j in range(len(env_files)):
                out.write(f"{sym[i][j]:6.2f} ")
            out.write("\n")
    with open(os.path.join(outdir, "Jacard_alt.txt"), "w") as out:
        out.write("The[31mWarning! alternative <<Jaccard distance>> (1 - AB/A):\n\n")
        for i, f in enumerate(env_files):
            out.write(str(f))
            for j in range(len(env_files)):
                out.write(f"{alt[i][j]:6.2f} ")
            out.write("\n")
