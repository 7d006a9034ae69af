"""Output writers: graph.txt, seqs.fasta, GFA, TSV, kmers.bin/stat.txt,
FASTQ, FASTA, BINQ.

Carried over from metacherchant_tpu/io/writers.py; the outputs must stay
byte-identical to the JAX package's.

Formats replicate the reference byte-for-byte where the reference itself is
deterministic; line ORDER follows our deterministic node ids (sorted k-mers)
where the reference depends on JVM HashMap order (see SURVEY §7.3).
"""
from __future__ import annotations

import os
import struct
from typing import Iterable

import numpy as np

from .. import trace
from ..dna import normalize
from ..algo.contraction import Node

GENE_LABEL_SUFFIX = "_start"  # io/writers/GFAWriter.java:12


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def _wrote(*paths: str) -> None:
    """The bytes of the files just written go to the innermost open span,
    while a recording is open."""
    sp = trace.current()
    if sp is not trace.NO_SPAN:
        sp.set(bytes=sum(os.path.getsize(p) for p in paths))


# ---------------------------------------------------------------------------
# graph.txt (a.k.a. env.txt)
# ---------------------------------------------------------------------------

@trace.traced("write.graph_txt")
def write_graph_txt(path: str, env_dict: dict[str, int]) -> None:
    """'kmer count' lines (OneSequenceCalculator.printEnvironment:297-310).
    Reference order is HashMap order; we emit sorted for determinism."""
    _ensure_dir(path)
    with open(path, "w") as out:
        for kmer in sorted(env_dict):
            out.write(f"{kmer} {env_dict[kmer]}\n")
    _wrote(path)


_POW10 = 10 ** np.arange(19, dtype=np.int64)  # int64 holds < 10^19


def _digits(nums: np.ndarray) -> np.ndarray:
    """Decimal digit count of nonnegative int64s via integer thresholds.

    floor(log10(n))+1 is float-rounding dependent (ADVICE r4: log10 of
    999999999999999 rounds up on this machine); searchsorted on the exact
    power-of-ten table is branch-free and always right. 0 -> 1 digit."""
    return np.maximum(
        np.searchsorted(_POW10, np.asarray(nums, np.int64), side="right"), 1
    ).astype(np.int64)


@trace.traced("write.graph_txt")
def write_graph_txt_codes(path: str, codes: np.ndarray, counts: np.ndarray,
                          k: int) -> None:
    """Vectorized write_graph_txt straight from oriented k-mer codes:
    decode to a char matrix, lexsort rows (== the string sort of the dict
    path), assemble one bytes blob. Byte-identical to
    write_graph_txt(env.as_dict()) -- pinned by the golden tests."""
    from ..dna import CODE_TO_CHAR

    _ensure_dir(path)
    n = int(codes.size)
    if n == 0:
        open(path, "w").close()
        return
    codes = np.asarray(codes, np.int64)
    counts = np.asarray(counts, np.int64)
    shifts = (2 * np.arange(k - 1, -1, -1, dtype=np.int64))
    chars = CODE_TO_CHAR[(codes[:, None] >> shifts[None, :]) & 3]  # (n,k) u8
    order = np.lexsort(chars.T[::-1])
    chars = chars[order]
    cnts = counts[order]
    d = _digits(cnts)
    maxd = int(d.max())
    divs = 10 ** np.arange(maxd - 1, -1, -1, dtype=np.int64)
    dig = ((cnts[:, None] // divs[None, :]) % 10 + ord("0")).astype(np.uint8)
    dig_flat = dig[np.arange(maxd)[None, :] >= (maxd - d)[:, None]]

    rec_len = k + 2 + d  # kmer ' ' digits '\n'
    off = np.cumsum(rec_len) - rec_len
    out = np.empty(int(rec_len.sum()), np.uint8)
    col = np.arange(k, dtype=np.int64)
    out[(off[:, None] + col[None, :]).ravel()] = chars.ravel()
    out[off + k] = ord(" ")
    base = np.cumsum(d) - d
    pos = (np.repeat(off + k + 1, d)
           + (np.arange(dig_flat.size, dtype=np.int64) - np.repeat(base, d)))
    out[pos] = dig_flat
    out[off + k + 1 + d] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(out.tobytes())
    _wrote(path)


def load_graph_txt(path: str) -> dict[str, int]:
    """DeBruijnGraphUtils.loadGraph (src/io/graph/DeBruijnGraphUtils.java:13-27)."""
    graph: dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            tokens = line.split(" ")
            graph[tokens[0]] = int(tokens[1])
    return graph


# ---------------------------------------------------------------------------
# seqs.fasta
# ---------------------------------------------------------------------------

def _node_label(node: Node) -> str:
    """min(id, rc.id)+1 with _start suffix for gene nodes
    (OneSequenceCalculator.getNodeId:452-455, GFAWriter.getNodeId:84-86)."""
    return f"{node.min_id() + 1}{GENE_LABEL_SUFFIX if node.is_gene else ''}"


def _neighbor_ids(node: Node) -> list[int]:
    """TreeSet of neighbor min-ids (both orientations), minus self
    (OneSequenceCalculator.getNeighborIds:375-385)."""
    ids = {nb.min_id() + 1 for nb in node.neighbors}
    ids |= {nb.min_id() + 1 for nb in node.rc.neighbors}
    ids.discard(node.min_id() + 1)
    return sorted(ids)


@trace.traced("write.seqs_fasta")
def write_seqs_fasta(path: str, nodes: list[Node], chunk_length: int) -> None:
    """outputNodeSequences (OneSequenceCalculator.java:354-373): alive nodes
    with id < rc.id and length >= chunkLength."""
    _ensure_dir(path)
    with open(path, "w") as out:
        for n in nodes:
            if n.deleted or n.id >= n.rc.id or len(n.seq) < chunk_length:
                continue
            ids = _neighbor_ids(n)
            out.write(f"> Id{_node_label(n)} Length:{len(n.seq)} "
                      f"Neighbors:[{', '.join(map(str, ids))}]\n")
            out.write(n.seq + "\n")
    _wrote(path)


# ---------------------------------------------------------------------------
# GFA
# ---------------------------------------------------------------------------

def _node_coverage(node: Node, k: int, subgraph: dict[str, int]) -> int:
    """KC tag: sum of subgraph counts over constituent k-mers, plus the last
    k-mer's count * (k-1) (GFAWriter.printLabel:88-99)."""
    cov = 0
    for i in range(len(node.seq) - k + 1):
        cov += subgraph[normalize(node.seq[i:i + k])]
    cov += subgraph[normalize(node.seq[len(node.seq) - k:])] * (k - 1)
    return cov


@trace.traced("write.gfa")
def write_gfa(path: str, nodes: list[Node], k: int,
              subgraph: dict[str, int], color_tag: str = "CL") -> None:
    """GFAWriter.printGraph (src/io/writers/GFAWriter.java:47-99):
    S lines for alive nodes in canonical orientation (seq <= rc.seq, ASCII);
    L lines for every alive adjacency, orientation signs by seq-vs-rc order."""
    _ensure_dir(path)
    with open(path, "w") as out:
        for n in nodes:
            if not n.deleted and n.seq <= n.rc.seq:
                cov = _node_coverage(n, k, subgraph)
                color = f"\t{color_tag}:Z:{n.color}" if n.color is not None else ""
                out.write(f"S\t{_node_label(n)}\t{n.seq}\tLN:i:{len(n.seq)}"
                          f"\tKC:i:{cov}{color}\n")
        for n in nodes:
            if n.deleted:
                continue
            for m in n.neighbors:
                if m.deleted:
                    continue
                sign_a = "+" if n.seq >= n.rc.seq else "-"
                sign_b = "+" if m.seq <= m.rc.seq else "-"
                out.write(f"L\t{_node_label(n)}\t{sign_a}\t{_node_label(m)}"
                          f"\t{sign_b}\t{k - 1}M\n")
    _wrote(path)


# ---------------------------------------------------------------------------
# TSV (Cytoscape)
# ---------------------------------------------------------------------------

@trace.traced("write.tsvs")
def write_tsvs(outdir: str, nodes: list[Node], k: int) -> None:
    """TSVWriter (src/io/writers/TSVWriter.java:27-87): nodes.tsv uses the
    node's OWN index+1 as id (:51-55); edges.tsv rows are
    'signedId(first.rc)\\tsignedId(second)\\tpp' under a 2-column header
    (:66-86) -- the 3-field rows replicate the reference exactly."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "nodes.tsv"), "w") as out:
        out.write("id\tlength\tseq\n")
        for n in nodes:
            if not n.deleted and n.seq <= n.rc.seq:
                out.write(f"{n.id + 1}\t{len(n.seq)}\t{n.seq}\n")

    def signed_id(node: Node) -> str:
        base = (str(node.id + 1) if node.seq <= node.rc.seq
                else f"-{node.rc.id + 1}")
        return base + (GENE_LABEL_SUFFIX if node.is_gene else "")

    with open(os.path.join(outdir, "edges.tsv"), "w") as out:
        out.write("source\ttarget\n")
        for n in nodes:
            if n.deleted:
                continue
            for m in n.neighbors:
                if not m.deleted:
                    out.write(f"{signed_id(n.rc)}\t{signed_id(m)}\tpp\n")
    _wrote(os.path.join(outdir, "nodes.tsv"),
           os.path.join(outdir, "edges.tsv"))


# ---------------------------------------------------------------------------
# kmers.bin + stat.txt
# ---------------------------------------------------------------------------

def write_kmers_bin(path: str, stat_path: str, keys: np.ndarray,
                    counts: np.ndarray, threshold: int = 0) -> int:
    """IOUtils.printKmers (src/io/IOUtils.java:39-65): big-endian int64 key +
    int16 count records for count > threshold; frequency histogram of ALL
    entries to stat.txt ('freq\\tnumber' sorted, with header + trailing blank
    line, itmo:statistics/QuickQuantitativeStatistics.java:37-76).
    Returns the number of records written."""
    _ensure_dir(path)
    keys = np.asarray(keys, np.int64)
    counts = np.asarray(counts, np.int64)
    good_mask = counts > threshold
    gk = keys[good_mask]
    gc = counts[good_mask].astype(np.int16)
    rec = np.empty(gk.size, dtype=np.dtype([("k", ">i8"), ("c", ">i2")]))
    rec["k"] = gk
    rec["c"] = gc
    with open(path, "wb") as out:
        rec.tofile(out)
    _ensure_dir(stat_path)
    freqs, nums = np.unique(counts, return_counts=True)
    with open(stat_path, "w") as out:
        out.write("# k-mer frequency\tnumber of such k-mers\n")
        for f, n in zip(freqs.tolist(), nums.tolist()):
            out.write(f"{f}\t{n}\n")
        out.write("\n")
    _wrote(path, stat_path)
    return int(gk.size)


def read_kmers_bin(path: str, threshold: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Load kmers.bin records with count > threshold
    (IOUtils.loadKmers:94-126 + KmersLoadWorker:14-32)."""
    rec = np.fromfile(path, dtype=np.dtype([("k", ">i8"), ("c", ">i2")]))
    keys = rec["k"].astype(np.int64)
    counts = rec["c"].astype(np.int32)
    keep = counts > threshold
    return keys[keep], counts[keep]


# ---------------------------------------------------------------------------
# FASTQ / FASTA writers
# ---------------------------------------------------------------------------

def write_fastq(path: str, records: Iterable[tuple[str, str, np.ndarray]],
                quality: str = "illumina") -> None:
    """WritersUtils.writeDnaQsToFastqFile (Illumina Phred+64 encoding default,
    itmo:io/writers/WritersUtils.java:50-80)."""
    offset = 64 if quality == "illumina" else 33
    _ensure_dir(path)
    with open(path, "w") as out:
        for name, seq, phred in records:
            q = "".join(chr(min(int(p), 62) + offset) for p in phred)
            out.write(f"@{name}\n{seq}\n+\n{q}\n")


def format_fastq_blob(codes: np.ndarray, phred: np.ndarray,
                      lengths: np.ndarray, idx: np.ndarray,
                      start_n: int, offset: int) -> bytes:
    """Assemble a whole bin of fastq records as ONE bytes blob, no per-read
    Python (VERDICT r3 #6: the routing was vectorized but the I/O layer was
    record-at-a-time). Byte-identical to FastqWriter._format records:
    `@<n>\\n<seq>\\n+\\n<qual>\\n`, numbers start_n.. consecutive, Phred
    clamped at 62 + offset (itmo:io/writers/WritersUtils.java:50-80).

    codes (B, L) with values 0..3 (A=0,G=1,C=2,T=3), phred (B, L), lengths
    (B,), idx = selected rows in output order. Variable-length segments are
    filled with the repeat/arange flat-index trick -- pure numpy throughout.
    """
    from ..dna import CODE_TO_CHAR

    idx = np.asarray(idx)
    nb = int(idx.size)
    if nb == 0:
        return b""
    n = lengths[idx].astype(np.int64)
    L = codes.shape[1]
    col = np.arange(L, dtype=np.int64)[None, :]
    mask = col < n[:, None]
    seq_flat = CODE_TO_CHAR[np.clip(codes[idx], 0, 3)][mask]
    qual_flat = (np.minimum(phred[idx].astype(np.int64), 62)
                 + offset).astype(np.uint8)[mask]

    nums = np.arange(start_n, start_n + nb, dtype=np.int64)
    d = _digits(nums)  # digit counts (nums >= 1)

    def digit_mat(sub_nums: np.ndarray, dd: int) -> np.ndarray:
        """(len, dd) uint8 ASCII digits of numbers that all have dd digits."""
        divs = 10 ** np.arange(dd - 1, -1, -1, dtype=np.int64)
        return ((sub_nums[:, None] // divs[None, :]) % 10 + ord("0")).astype(
            np.uint8)

    if np.all(n == n[0]):
        # uniform read length (the Illumina common case): records within one
        # digit-count group share a fixed layout, so the whole group is one
        # contiguous (rows, rec_len) column assembly -- no scatter fills.
        # Record numbers are consecutive, so there are O(1) digit groups.
        ln = int(n[0])
        seq_mat = seq_flat.reshape(nb, ln)
        qual_mat = qual_flat.reshape(nb, ln)
        parts = []
        starts = np.flatnonzero(np.diff(d, prepend=d[0] - 1))
        for gi, s in enumerate(starts):
            e = starts[gi + 1] if gi + 1 < starts.size else nb
            dd = int(d[s])
            g = e - s
            rec = np.empty((g, dd + 2 * ln + 6), np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1:1 + dd] = digit_mat(nums[s:e], dd)
            rec[:, 1 + dd] = ord("\n")
            rec[:, 2 + dd:2 + dd + ln] = seq_mat[s:e]
            rec[:, 2 + dd + ln] = ord("\n")
            rec[:, 3 + dd + ln] = ord("+")
            rec[:, 4 + dd + ln] = ord("\n")
            rec[:, 5 + dd + ln:5 + dd + 2 * ln] = qual_mat[s:e]
            rec[:, 5 + dd + 2 * ln] = ord("\n")
            parts.append(rec.reshape(-1))
        return np.concatenate(parts).tobytes()

    maxd = int(d.max())
    num_mat = digit_mat(nums, maxd)  # left-padded with '0' columns
    dig_flat = num_mat[np.arange(maxd)[None, :] >= (maxd - d)[:, None]]

    rec_len = d + 2 * n + 6  # '@' d '\n' seq '\n' '+' '\n' qual '\n'
    off = np.cumsum(rec_len) - rec_len
    out = np.empty(int(rec_len.sum()), np.uint8)

    def fill(starts: np.ndarray, seg: np.ndarray, values: np.ndarray) -> None:
        if values.size == 0:
            return
        base = np.cumsum(seg) - seg
        pos = (np.repeat(starts, seg)
               + (np.arange(values.size, dtype=np.int64) - np.repeat(base, seg)))
        out[pos] = values

    out[off] = ord("@")
    fill(off + 1, d, dig_flat)
    out[off + 1 + d] = ord("\n")
    fill(off + 2 + d, n, seq_flat)
    p = off + 2 + d + n
    out[p] = ord("\n")
    out[p + 1] = ord("+")
    out[p + 2] = ord("\n")
    fill(off + 5 + d + n, n, qual_flat)
    out[off + 5 + d + 2 * n] = ord("\n")
    return out.tobytes()


class FastqWriter:
    """Incremental fastq writer for streaming classification.

    Record format of the reference's fastq writer (Illumina Phred+64 default,
    itmo:io/writers/WritersUtils.java:50-80) with reads renamed to 1-based
    sequence numbers per output file (itmo:io/writers/DataCounter.java:22-24).
    Lets the classifier family route reads bin-by-bin in O(batch) memory
    instead of materializing whole read files (the reference streams pairs,
    itmo:io/sources/PairSource.java:22-57).
    """

    def __init__(self, path: str, quality: str = "illumina"):
        _ensure_dir(path)
        self._offset = 64 if quality == "illumina" else 33
        self._f = open(path, "wb")
        self._n = 0

    def _format(self, dnaq) -> str:
        self._n += 1
        q = (np.minimum(np.asarray(dnaq.phred, np.int16), 62)
             + self._offset).astype(np.uint8).tobytes().decode("latin-1")
        return f"@{self._n}\n{dnaq.to_string()}\n+\n{q}\n"

    def write(self, dnaq) -> None:
        """One record (a readers.DnaQ), numbered after the last one."""
        self._f.write(self._format(dnaq).encode("latin-1"))

    def write_many(self, dnaqs) -> None:
        """Records of several DnaQs: one formatting pass, one file write."""
        if dnaqs:
            self._f.write(
                "".join(self._format(d) for d in dnaqs).encode("latin-1"))

    def write_batch(self, codes: np.ndarray, phred: np.ndarray,
                    lengths: np.ndarray, idx: np.ndarray) -> None:
        """Vectorized bin write straight from ReadBatch-style arrays: one
        numpy blob assembly + one file write, zero per-read Python."""
        blob = format_fastq_blob(codes, phred, lengths, idx,
                                 self._n + 1, self._offset)
        self._n += int(np.asarray(idx).size)
        self._f.write(blob)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_fasta(path: str, records: Iterable[tuple[str, str]]) -> None:
    """'>name' and sequence lines, one pair per (name, seq) record."""
    _ensure_dir(path)
    with open(path, "w") as out:
        for name, seq in records:
            out.write(f">{name}\n{seq}\n")


def write_binq(path: str, dnaqs) -> None:
    """BINQ writer: int32 big-endian length + (phred<<2 | nuc) bytes per read
    (inverse of readers._iter_binq; itmo:dna/DnaQ.java:140-150 layout)."""
    _ensure_dir(path)
    with open(path, "wb") as out:
        for d in dnaqs:
            data = ((np.minimum(d.phred.astype(np.int32), 62) << 2)
                    | (d.codes.astype(np.int32) & 3)).astype(np.uint8)
            out.write(struct.pack(">i", len(data)))
            out.write(data.tobytes())
