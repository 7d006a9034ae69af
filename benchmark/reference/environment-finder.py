"""Plain reference of environment-finder in the exact regime (k <= 31).

What MetaCherchant's environment-finder computes for one gene
(OneSequenceCalculator: buildEnvironment, runBfs, createPicture), worked out
again from the reads:

- counts: every canonical k-mer of the reads (recount.py);
- seeds: every k-window of the gene whose count reaches --coverage;
- environment: for each direction, left (a base put before the k-mer's
  first k-1) and right (one put after its last k-1), a breadth-first search
  over oriented k-mers from the seeds that admits a neighbour whose count
  reaches --coverage while it lies within --maxradius steps; the union of
  both directions, each k-mer in the orientation whose string sorts first
  (A < C < G < T), with its count: graph.txt;
- unitigs: the environment's de Bruijn graph (an oriented k-mer u leads to v
  when u's last k-1 bases are v's first), every maximal path whose inner
  links are the only way out of u and into v, between k-mers that agree on
  whether they lie in the gene (forward or reverse): seqs.fasta's sequences;
  graph.gfa's segments are the same unitigs in their first-sorting
  orientation, with their length, their coverage (the counts of their
  k-mers, plus the last k-mer's count times k - 1) and GREEN for gene
  unitigs.

The search runs on the host in numpy over the sorted recount; it imports
nothing of the program, and reads the program's files only to judge them.
"""
from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from benchmark.reference import recount

LIMITS = {"graph_kmers_wrong": 0, "graph_counts_wrong": 0,
          "unitigs_wrong": 0, "gfa_segments_wrong": 0}

_COMP = str.maketrans("ACGT", "TGCA")
_U = np.uint64


def revcomp_str(s: str) -> str:
    return s.translate(_COMP)[::-1]


def norm(s: str) -> str:
    return min(s, revcomp_str(s))


def revcomp_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Reverse complements of oriented int64 codes: the 32 two-bit digits
    of the word reversed, the k-mer's brought down, every base complemented
    (A=0 <-> T=3, G=1 <-> C=2)."""
    x = codes.astype(_U)
    for shift, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                     (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = ((x >> _U(shift)) & _U(m)) | ((x & _U(m)) << _U(shift))
    x = (x >> _U(32)) | (x << _U(32))
    x >>= _U(64 - 2 * k)
    return (x ^ _U((1 << (2 * k)) - 1)).astype(np.int64)


def decode(codes: np.ndarray, k: int) -> list[str]:
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.int64)
    digits = (codes[:, None] >> shifts[None, :]) & 3
    chars = np.frombuffer(b"AGCT", np.uint8)[digits]
    return [row.tobytes().decode() for row in chars]


def encode_windows(seq: str, k: int) -> np.ndarray:
    digits = np.frombuffer(b"AGCT", np.uint8)
    lut = np.zeros(256, np.int64)
    lut[digits] = np.arange(4)
    c = lut[np.frombuffer(seq.encode(), np.uint8)]
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, np.int64)
    out = np.zeros(n, np.int64)
    for j in range(k):
        out = out * 4 + c[j:j + n]
    return out


def read_fasta(path: str) -> list[tuple[str, str]]:
    out, name = [], None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:].split()[0]
                out.append([name, ""])
            elif line:
                out[-1][1] += line
    return [(n, s) for n, s in out]


def environments(seqs: list[str], k: int, keys: np.ndarray,
                 counts: np.ndarray, coverage: int, radius: int
                 ) -> list[np.ndarray | None]:
    """Oriented codes of each sequence's environment (both directions'
    searches united), or None where no seed reaches the coverage."""
    mask = (1 << (2 * k)) - 1

    def occ(codes: np.ndarray) -> np.ndarray:
        return recount.lookup(keys, counts,
                              np.minimum(codes, revcomp_codes(codes, k)))

    seeds = []
    for seq in seqs:
        w = encode_windows(seq, k)
        seeds.append(w[occ(w) >= coverage])
    result: list[set[int]] = [set() for _ in seqs]
    nucs = np.arange(4, dtype=np.int64)
    for direction in (-1, 1):
        visited = [set(s.tolist()) for s in seeds]
        front = [(g, c) for g, s in enumerate(visited) for c in s]
        for _ in range(radius):
            if not front:
                break
            grp = np.array([g for g, _ in front], np.int64)
            cur = np.array([c for _, c in front], np.int64)
            if direction == -1:
                nb = (cur[:, None] >> 2) | (nucs[None, :] << (2 * k - 2))
            else:
                nb = ((cur[:, None] << 2) & mask) | nucs[None, :]
            ok = occ(nb.reshape(-1)).reshape(nb.shape) >= coverage
            front = []
            for r, j in zip(*np.nonzero(ok)):
                g, code = int(grp[r]), int(nb[r, j])
                if code not in visited[g]:
                    visited[g].add(code)
                    front.append((g, code))
        for g, v in enumerate(visited):
            result[g] |= v
    return [np.array(sorted(r), np.int64) if s.size else None
            for r, s in zip(result, seeds)]


def unitigs(env: dict[str, int], gene: str, k: int) -> list[str]:
    """The maximal non-branching paths of the environment's graph, cut
    where the gene ends (module docstring), each once, as found."""
    nodes = set(env) | {revcomp_str(s) for s in env}
    in_gene = {gene[i:i + k] for i in range(len(gene) - k + 1)}

    def tag(s: str) -> bool:
        return s in in_gene or revcomp_str(s) in in_gene

    def succ(u: str) -> list[str]:
        return [u[1:] + c for c in "ACGT" if u[1:] + c in nodes]

    def pred(u: str) -> list[str]:
        return [c + u[:-1] for c in "ACGT" if c + u[:-1] in nodes]

    def merge_next(u: str) -> str | None:
        s = succ(u)
        if len(s) != 1:
            return None
        v = s[0]
        if v == u or v == revcomp_str(u) or len(pred(v)) != 1 \
                or tag(u) != tag(v):
            return None
        return v

    used: set[str] = set()
    out = []
    for s in sorted(env):
        if s in used:
            continue
        start, seen = s, {s}
        while True:
            p = pred(start)
            if len(p) != 1 or merge_next(p[0]) != start or norm(p[0]) in seen:
                break
            start = p[0]
            seen.add(norm(start))
        seq, cur = start, start
        used.add(norm(start))
        while True:
            v = merge_next(cur)
            if v is None or norm(v) in used:
                break
            seq += v[-1]
            used.add(norm(v))
            cur = v
        out.append(seq)
    return out


def gene_outputs(codes: np.ndarray, gene: str, k: int, keys: np.ndarray,
                 counts: np.ndarray) -> dict:
    canon = np.minimum(codes, revcomp_codes(codes, k))
    cnt = recount.lookup(keys, counts, canon)
    env: dict[str, int] = {}
    for s, c in zip(decode(codes, k), cnt.tolist()):
        env[norm(s)] = c
    tigs = unitigs(env, gene, k)
    in_gene = {gene[i:i + k] for i in range(len(gene) - k + 1)}
    segments = []
    for u in tigs:
        seq = norm(u)
        kc = sum(env[norm(seq[i:i + k])] for i in range(len(seq) - k + 1))
        kc += env[norm(seq[-k:])] * (k - 1)
        first = seq[:k]
        gene_tag = first in in_gene or revcomp_str(first) in in_gene
        segments.append((seq, len(seq), kc, "GREEN" if gene_tag else None))
    return {"graph": env, "unitigs": Counter(norm(u) for u in tigs),
            "segments": Counter(segments)}


def solve(cfg: dict, reads: str, genes: list[str], device: torch.device,
          key_bits: int | None = None) -> list[dict]:
    """Per job (one FASTA of genes each), per gene name: the expected
    outputs, or None where the gene has no seed."""
    k = cfg["k"]
    keys, counts = recount.count(recount.read_fastq_codes(reads), k, device,
                                 key_bits)
    jobs = [read_fasta(path) for path in genes]
    flat = [seq for job in jobs for _, seq in job]
    envs = iter(environments(flat, k, keys, counts, cfg["coverage"],
                             cfg["maxradius"]))
    out = []
    for job in jobs:
        want = {}
        for name, seq in job:
            codes = next(envs)
            want[name] = (None if codes is None else
                          gene_outputs(codes, seq, k, keys, counts))
        out.append(want)
    return out


def read_outputs(cfg: dict, job) -> dict:
    """What the program wrote for each gene of the job (its out_dir and
    genes); None where it wrote no directory."""
    got = {}
    for name, _ in read_fasta(job.genes):
        gdir = os.path.join(job.out_dir, name)
        if not os.path.isdir(gdir):
            got[name] = None
            continue
        graph = {}
        with open(os.path.join(gdir, "graph.txt")) as fh:
            for line in fh:
                kmer, c = line.split()
                graph[kmer] = int(c)
        tigs: Counter = Counter()
        with open(os.path.join(gdir, "seqs.fasta")) as fh:
            for line in fh:
                if line.strip() and not line.startswith(">"):
                    tigs[norm(line.strip())] += 1
        segments: Counter = Counter()
        with open(os.path.join(gdir, "graph.gfa")) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if f[0] != "S":
                    continue
                tags = dict(t.split(":", 2)[::2] for t in f[3:])
                segments[(f[2], int(tags["LN"]), int(tags["KC"]),
                          tags.get("CL"))] += 1
        got[name] = {"graph": graph, "unitigs": tigs, "segments": segments}
    return got


def _sym(a: Counter, b: Counter) -> int:
    return sum(((a - b) + (b - a)).values())


def compare(want: dict, got: dict) -> dict[str, int]:
    """The numbers held to LIMITS, summed over the job's genes."""
    out = dict.fromkeys(LIMITS, 0)
    for name, w in want.items():
        g = got.get(name)
        if w is None or g is None:
            if w is not g:
                full = w or g
                out["graph_kmers_wrong"] += len(full["graph"])
                out["unitigs_wrong"] += sum(full["unitigs"].values())
                out["gfa_segments_wrong"] += sum(full["segments"].values())
            continue
        wk, gk = set(w["graph"]), set(g["graph"])
        out["graph_kmers_wrong"] += len(wk ^ gk)
        out["graph_counts_wrong"] += sum(w["graph"][x] != g["graph"][x]
                                         for x in wk & gk)
        out["unitigs_wrong"] += _sym(w["unitigs"], g["unitigs"])
        out["gfa_segments_wrong"] += _sym(w["segments"], g["segments"])
    return out
