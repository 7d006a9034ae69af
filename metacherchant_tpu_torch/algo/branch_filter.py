"""Legacy BLAST branch filtration of a contracted environment.

Counterpart of metacherchant_tpu/algo/branch_filter.py (host code): a
faithful library-level equivalent of the reference's obsolete read-coverage
branch filter (src/algo/OneSequenceCalculator.java:468-532 filter(),
:534-544 walk(), :341-352 createFilteredPicture). In the reference the CLI
wiring of this path is commented out (src/tools/EnvironmentFinderMain.java:
107-119 parameters, :189-218 invocation, marked "Obsolete code ... Needs
redesign"), so -- matching that surface -- no tool here invokes it either; it
is exposed as a library API with the same semantics:

1. For every junction node (alive, >1 neighbors, or exactly 1 neighbor after a
   previous removal marked it `changed`), write a query FASTA of its junction
   sequences: per neighbor, the last <=100 bp of the neighbor's rc sequence
   spliced with the node's own sequence past the (k-1) overlap (:474-484).
2. BLAST each query file against the cutReads database (made by the
   ReadsCoverage shim from ReadsFilter's extracted reads) with
   `blastn -task blastn-short -outfmt "6 qaccver length pident"`
   (src/algo/Filter.java:32-48).
3. A hit supports neighbor j iff length*pident >= expected_length*100, i.e.
   a full-length perfect alignment (:491-497). Neighbors with support below
   `min_occurences` that are not gene nodes lose their edge, symmetrically,
   and both endpoints are marked `changed` (:500-511).
4. The surviving picture is the DFS closure (walk, :534-544) of the alive
   gene nodes over remaining edges, each node paired with its rc (:519-527).

createFilteredPicture then re-emits seqs.fasta / graph.gfa / tsvs under
`<output_prefix>/filtered` over the filtered node array (:341-352).
"""
from __future__ import annotations

import os
from typing import Callable

from .contraction import Node
from ..io.extra_writers import run_blast_filter


def _node_id(n: Node) -> str:
    """getNodeId (OneSequenceCalculator.java:464-466)."""
    return f"{n.min_id() + 1}{'_start' if n.is_gene else ''}"


def filter_branches(nodes: list[Node], k: int, min_occurences: int,
                    work_prefix: str, logger,
                    threads: int = 8,
                    blast_runner: Callable[..., bool] = run_blast_filter,
                    ) -> list[Node]:
    """filter() (OneSequenceCalculator.java:468-532).

    `work_prefix` is the tool workDir path (queries and .out files go under
    `<work_prefix>/db/`, next to the dbReads BLAST database made by the
    ReadsCoverage shim, src/algo/ReadsCoverage.java:30-37). Returns the
    filtered node array (gene-reachable closure incl. rc pairs).
    """
    db_dir = os.path.join(work_prefix, "db")
    os.makedirs(db_dir, exist_ok=True)
    cnt = 0
    starts: list[Node] = []
    for n in nodes:
        if not n.deleted and (len(n.neighbors) > 1
                              or (len(n.neighbors) == 1 and n.changed)):
            query = os.path.join(db_dir, f"{cnt}.fasta")
            lengths = []
            with open(query, "w") as out:
                for j, neigh in enumerate(n.neighbors):
                    out.write(f">{j} {_node_id(n)}->{_node_id(neigh)}\n")
                    other = neigh.rc.seq
                    len1 = min(len(other), 100)
                    len2 = min(len(n.seq), 100)
                    lengths.append(len1 + len2 - (k - 1))
                    out.write(other[len(other) - len1:]
                              + n.seq[k - 1:len2] + "\n")
            out_path = os.path.join(db_dir, f"{cnt}.out")
            ok = blast_runner(os.path.join(db_dir, "dbReads"), query,
                              out_path, threads, logger)
            res = [0] * len(n.neighbors)
            if ok and os.path.exists(out_path):
                with open(out_path) as filtered:
                    for line in filtered:
                        parts = line.split()
                        if len(parts) < 3:
                            continue
                        q, length, pident = (int(parts[0]), int(parts[1]),
                                             float(parts[2]))
                        if length * pident >= lengths[q] * 100:
                            res[q] += 1
            # iterate a snapshot: edge removal mutates n.neighbors (:503-506)
            neighbs = list(n.neighbors)
            for j, tmp in enumerate(neighbs):
                if res[j] < min_occurences and not tmp.is_gene:
                    n.neighbors.remove(tmp)
                    tmp.neighbors.remove(n)
                    n.changed = True
                    tmp.changed = True
            cnt += 1
        if not n.deleted and n.is_gene:
            starts.append(n)

    filtered: set[int] = set()
    by_id: dict[int, Node] = {}

    def add(x: Node) -> None:
        filtered.add(id(x))
        by_id[id(x)] = x

    # walk (:534-544), iterative to avoid Python recursion limits
    def walk(node: Node) -> None:
        stack = [node]
        while stack:
            cur = stack.pop()
            cur.visited = True
            for m in cur.neighbors:
                if not m.visited and not m.deleted:
                    add(m)
                    add(m.rc)
                    stack.append(m)
                    stack.append(m.rc)

    for node in starts:
        if not node.visited and not node.deleted:
            add(node)
            add(node.rc)
            walk(node)
            walk(node.rc)
    return list(by_id.values())


def create_filtered_picture(filtered_nodes: list[Node], k: int,
                            subgraph: dict[str, int], output_prefix: str,
                            chunk_length: int) -> None:
    """createFilteredPicture (OneSequenceCalculator.java:341-352)."""
    from ..io.writers import write_seqs_fasta, write_gfa, write_tsvs
    out = os.path.join(output_prefix, "filtered")
    write_seqs_fasta(os.path.join(out, "seqs.fasta"), filtered_nodes,
                     chunk_length)
    write_gfa(os.path.join(out, "graph.gfa"), filtered_nodes, k, subgraph)
    write_tsvs(os.path.join(out, "tsvs"), filtered_nodes, k)
