"""Unitig contraction as parallel pointer jumping on the torch device (B12).

Counterpart of metacherchant_tpu/ops/contraction_device.py, an XLA op in the
JAX package (no Pallas kernel), so plain torch here. The reference's repeated
full-array merge sweeps (src/algo/OneSequenceCalculator.java:434-451 doMerge)
become searchsorted adjacency over the doubled-node universe of oriented
k-mer codes plus fixed-round pointer doubling.

Semantics: the reference merges node n into its unique neighbor m when
|neighbors(n)| == 1, |neighbors(m)| == 1 and tags match; in successor-edge
terms (neighbors(n) = successors of n.rc) that contracts every edge u -> v
with outdeg(u) == 1, indeg(v) == 1, tag(u) == tag(v). The fixpoint is the
maximal-unitig decomposition with tag barriers, computed directly here.
Deliberate divergences from the order-faithful host sweep
(algo/contraction.py), the same as the JAX device route's:

- self-loop (u -> u) and hairpin (u -> rc(u)) edges are never contracted;
  the reference's sweep merges some of them order-dependently
- odd k only (an even-k palindromic k-mer would alias its rc node)
- record order and strand choice of the written pictures differ from the
  host sweep; the unitig set is the same

Outputs feed assemble_nodes(), which rebuilds the writer-facing Node pairs +
symmetric adjacency with the same (k-1)-overlap rule as build_node_graph.
"""
from __future__ import annotations

import numpy as np
import torch

from ..algo.contraction import Node
from ..device import device
from ..dna import (NUCLEOTIDES, code_to_kmer, normalize,
                   reverse_complement)
from .kmers import fw_codes_of_kmer_strings


def _revcomp(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mer codes (itmo:utils/KmerUtils.java
    :12-22) in int64: torch on the CPU has no uint64 shift, so each logical
    right shift is an arithmetic one masked to the bits it keeps, which is
    exact for every int64 input, top bit included."""
    c = codes
    for s, lo in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF),
                  (32, 0x00000000FFFFFFFF)):
        c = ((c & lo) << s) | ((c >> s) & lo)
    return (~c >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)


def contract_codes_device(codes: torch.Tensor, tags: torch.Tensor, k: int):
    """codes: (N,) int64 k-mer codes, one orientation per k-mer (any order);
    tags: (N,) int32 merge tags (gene flag / color id). On their device.

    Returns (U, utags, head, dist):
      U     (2N,) int64 sorted oriented codes (the doubled-node universe)
      utags (2N,) int32 tag per oriented node
      head  (2N,) int32 index into U of each node's chain head
      dist  (2N,) int32 distance from head along the chain
    """
    if k % 2 == 0:
        raise ValueError("device contraction requires odd k")
    U = torch.cat([codes, _revcomp(codes, k)])
    utags = torch.cat([tags, tags])
    U, order = torch.sort(U, stable=True)
    utags = utags[order]
    M = U.numel()
    idx = torch.arange(M, device=U.device)
    nucs = torch.arange(4, dtype=torch.int64, device=U.device)

    def member(q):
        pos = torch.searchsorted(U, q).clamp_max_(M - 1)
        return U[pos] == q, pos

    # successor candidates: u[1:] + n
    r_hit, r_pos = member(((U[:, None] << 2) & ((1 << (2 * k)) - 1))
                          | nucs[None, :])
    outdeg = r_hit.sum(dim=1)
    # the unique successor where outdeg == 1; elsewhere a sum of positions,
    # clamped into range for the gathers below (jnp gathers clamp) and
    # masked off by outdeg == 1
    succ = torch.where(r_hit, r_pos, 0).sum(dim=1).clamp_max_(M - 1)
    # predecessor candidates: n + u[:-1]
    l_hit, _ = member((U[:, None] >> 2) | (nucs[None, :] << (2 * k - 2)))
    indeg = l_hit.sum(dim=1)
    rc_idx = member(_revcomp(U, k))[1]

    chain = ((outdeg == 1) & (indeg[succ] == 1) & (utags == utags[succ])
             & (succ != idx) & (succ != rc_idx))

    # parent pointer toward the head: parent[v] = u for contracted u -> v;
    # indeg(v) == 1 makes the claiming u unique, so the scatter writes each
    # target once
    parent = idx.clone()
    parent[succ[chain]] = idx[chain]

    # Chain components are either root-terminated paths or pure cycles.
    # Phase 1: pointer doubling propagating (rooted?, min-ancestor); phase
    # 2: break each cycle at its min node and jump to the final heads. Both
    # run the JAX package's fixed round count, so head and dist are its.
    rounds = int(np.ceil(np.log2(max(M, 2)))) + 1
    h, rooted, mn = parent, parent == idx, torch.minimum(idx, parent)
    for _ in range(rounds):
        h, rooted, mn = h[h], rooted | rooted[h], torch.minimum(mn, mn[h])
    parent = torch.where((~rooted) & (idx == mn), idx, parent)
    h, d = parent, (parent != idx).to(torch.int32)
    for _ in range(rounds):
        h, d = h[h], d + d[h]
    return U, utags, h.to(torch.int32), d


def contract_device(kmers: list[str], k: int, tag_of=None,
                    decorate=None) -> list[Node]:
    """Canonical k-mer strings -> contracted writer-facing Node list, the
    contraction on the device of device.py. tag_of(seq, rc) -> hashable
    merge tag (default: False); decorate(node, tag) applies tag attributes
    to a node (default: bool tag -> is_gene + GREEN color, like
    build_node_graph's default)."""
    if not kmers:
        return []
    codes = fw_codes_of_kmer_strings(kmers, k)
    tag_values = []
    tag_ids: dict = {}
    for s in kmers:
        t = tag_of(s, reverse_complement(s)) if tag_of else False
        if t not in tag_ids:
            tag_ids[t] = len(tag_ids)
        tag_values.append(tag_ids[t])
    dev = device()
    U, utags, head, dist = (t.cpu().numpy() for t in contract_codes_device(
        torch.from_numpy(codes).to(dev),
        torch.from_numpy(np.asarray(tag_values, np.int32)).to(dev), k))
    unitigs = assemble_unitigs(U, head, dist, k)
    id_of_tag = {v: t for t, v in tag_ids.items()}
    return assemble_nodes(
        [(seq, id_of_tag[int(utags[h])]) for seq, h in unitigs], k,
        decorate=decorate)


def assemble_unitigs(U: np.ndarray, head: np.ndarray, dist: np.ndarray,
                     k: int) -> list[tuple[str, int]]:
    """(unitig string, head index) per chain, one orientation per rc-pair."""
    order = np.lexsort((dist, head))
    h_sorted = head[order]
    starts = np.flatnonzero(np.concatenate(
        [[True], h_sorted[1:] != h_sorted[:-1]]))
    ends = np.append(starts[1:], h_sorted.size)
    last_char = np.frombuffer(NUCLEOTIDES.encode(), np.uint8)[U & 3]
    out: list[tuple[str, int]] = []
    seen: set[str] = set()
    for s, e in zip(starts, ends):
        grp = order[s:e]
        h = int(h_sorted[s])
        seq = code_to_kmer(int(U[h]), k)
        if e - s > 1:
            seq = seq + last_char[grp[1:]].tobytes().decode("ascii")
        # each chain appears on both strands; the mirror of a LINEAR chain is
        # the exact reverse complement, while the mirror of a linearized
        # CYCLE breaks at a different rotation -- dedup rotation-invariantly
        if len(seq) > k and seq[: k - 1] == seq[-(k - 1):]:
            core = seq[: -(k - 1)]
            norm = min(_min_rotation(core),
                       _min_rotation(reverse_complement(core)))
        else:
            norm = normalize(seq)
        if norm in seen:
            continue
        seen.add(norm)
        out.append((seq, h))
    return out


def _min_rotation(s: str) -> str:
    return min(s[i:] + s[:i] for i in range(len(s)))


def reverse_complement_str(s: str) -> str:
    return reverse_complement(s)


def assemble_nodes(unitigs: list[tuple[str, object]], k: int,
                   decorate=None) -> list[Node]:
    """Node pairs + symmetric (k-1)-overlap adjacency over contracted seqs
    (generalizes build_node_graph's rule to length > k)."""
    nodes: list[Node] = []
    for seq, tag in unitigs:
        rc = reverse_complement(seq)
        a = Node(seq, len(nodes))
        b = Node(rc, len(nodes) + 1)
        a.rc, b.rc = b, a
        if decorate is not None:
            decorate(a, tag)
            decorate(b, tag)
        elif tag is True:
            a.is_gene = b.is_gene = True
            a.color = b.color = "GREEN"
        nodes.extend((a, b))
    by_prefix: dict[str, list[Node]] = {}
    for n in nodes:
        by_prefix.setdefault(n.seq[: k - 1], []).append(n)
    for n in nodes:
        hit = by_prefix.get(n.seq[-(k - 1):])
        if hit:
            n.rc.neighbors.extend(hit)
    return nodes
