"""The port's legacy BLAST branch filter (algo/branch_filter.py) and extra
writers (io/extra_writers.py): tests/test_branch_filter.py's cases with the
same stub BLAST runners, and every file against the JAX package's, byte for
byte."""
import logging
import os

import numpy as np
import pytest

from metacherchant_tpu.algo import branch_filter as jax_bf
from metacherchant_tpu.algo import contraction as jax_con
from metacherchant_tpu.io import extra_writers as jax_xw
from metacherchant_tpu_torch.algo import contraction as con
from metacherchant_tpu_torch.algo.branch_filter import (
    create_filtered_picture, filter_branches)
from metacherchant_tpu_torch.dna import normalize, reverse_complement
from metacherchant_tpu_torch.io import extra_writers as xw

K = 5
SPINE = "ACGGTCAGT"      # gene: ACGGT CGGTC GGTCA GTCAG TCAGT
BRANCH = "CGGTCGA"       # adds non-gene GGTCG GTCGA off the CGGTC junction
LOG = logging.getLogger("test")


def _kmers(*seqs, k=K):
    out = set()
    for s in seqs:
        for i in range(len(s) - k + 1):
            out.add(normalize(s[i:i + k]))
    return sorted(out)


def _build(pkg=con, genes=(SPINE,), seqs=(SPINE, BRANCH), k=K):
    return pkg.build_node_graph(_kmers(*seqs, k=k), k,
                                is_gene=pkg.gene_kmer_checker(list(genes), k))


def _tree(root) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def _runner(support: str):
    """A stub BLAST: per query record, a hit of full length and 100%
    identity ('full'), half length at 90% ('weak'), or none at all
    ('none', returning False as when blastn is missing)."""
    def run(db_prefix, query, out_path, threads, logger):
        assert db_prefix.endswith(os.path.join("db", "dbReads"))
        if support == "none":
            return False
        with open(query) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        with open(out_path, "w") as out:
            for i in range(0, len(lines), 2):
                idx = int(lines[i][1:].split()[0])
                n = len(lines[i + 1])
                out.write(f"{idx}\t{n}\t100.00\n" if support == "full"
                          else f"{idx}\t{max(1, n // 2)}\t90.00\n")
        return True
    return run


def test_filter_branches_removes_unsupported_and_walks_gene_closure(tmp_path):
    nodes = _build()
    assert [n for n in nodes if len(n.neighbors) > 1]
    queries = []

    def no_support_runner(*args):
        queries.append(args[1])
        return _runner("weak")(*args)

    filtered = filter_branches(nodes, K, 1, str(tmp_path), LOG,
                               blast_runner=no_support_runner)
    assert queries
    gene_set = set()
    for w in _kmers(SPINE):
        gene_set.update((w, reverse_complement(w)))
    got = {n.seq for n in filtered}
    assert got == gene_set
    branch_seqs = {"GGTCG", reverse_complement("GGTCG")}
    for n in filtered:
        for m in n.neighbors:
            assert m.seq not in branch_seqs


def test_filter_branches_keeps_supported_and_gene_edges(tmp_path):
    filtered = filter_branches(_build(), K, 1, str(tmp_path), LOG,
                               blast_runner=_runner("full"))
    all_seqs = set()
    for w in _kmers(SPINE, BRANCH):
        all_seqs.update((w, reverse_complement(w)))
    assert {n.seq for n in filtered} == all_seqs


def test_create_filtered_picture_outputs(tmp_path):
    filtered = filter_branches(_build(), K, 1, str(tmp_path), LOG,
                               blast_runner=_runner("none"))
    subgraph = {w: 1 for w in _kmers(SPINE, BRANCH)}
    out = tmp_path / "env"
    create_filtered_picture(filtered, K, subgraph, str(out), 1)
    for name in ("seqs.fasta", "graph.gfa", "tsvs/nodes.tsv"):
        assert (out / "filtered" / name).exists()
    gfa = (out / "filtered" / "graph.gfa").read_text()
    assert any(line.startswith("S\t") for line in gfa.splitlines())


def _branchy(k: int):
    """A 300 bp gene inside a 900 bp genome with three 40 bp side branches
    (junctions after contraction)."""
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 900))
    seqs = [genome]
    for p in (200, 450, 700):
        seqs.append(genome[p - k + 1:p] + "".join(rng.choice(list("ACGT"),
                                                             40)))
    return genome[300:600], seqs


@pytest.mark.parametrize("support", ["full", "weak", "none"])
@pytest.mark.parametrize("merge", [False, True], ids=["kmers", "unitigs"])
def test_filter_and_picture_match_jax(tmp_path, support, merge):
    """The same graph (k = 11, uncontracted or contracted) through both
    packages' filters with the same stub BLAST: the same query and .out
    files, the same surviving nodes and the same filtered picture."""
    k = 11
    gene, seqs = _branchy(k)
    subgraph = {w: i % 7 + 1 for i, w in enumerate(_kmers(*seqs, k=k))}
    files = {}
    for name, pkg, bf in (("port", con, filter_branches),
                          ("jax", jax_con, jax_bf.filter_branches)):
        nodes = _build(pkg, [gene], seqs, k)
        if merge:
            pkg.do_merge(nodes, k)
        filtered = bf(nodes, k, 1, str(tmp_path / name), LOG,
                      blast_runner=_runner(support))
        picture = (create_filtered_picture if name == "port"
                   else jax_bf.create_filtered_picture)
        picture(filtered, k, subgraph, str(tmp_path / name / "env"), 60)
        files[name] = (_tree(tmp_path / name),
                       sorted((n.id, n.seq) for n in filtered))
    assert files["port"] == files["jax"]
    assert any(p.endswith(".fasta") for p in files["port"][0])


@pytest.mark.parametrize("merge", [False, True], ids=["kmers", "unitigs"])
def test_extra_writers_match_jax(tmp_path, merge):
    """GML, Graphviz dot and Velvet LastGraph of the same graph, byte for
    byte against the JAX package's writers."""
    k = 11
    gene, seqs = _branchy(k)
    subgraph = {w: i % 5 + 1 for i, w in enumerate(_kmers(*seqs, k=k))}
    for name, pkg, mod in (("port", con, xw), ("jax", jax_con, jax_xw)):
        nodes = _build(pkg, [gene], seqs, k)
        if merge:
            pkg.do_merge(nodes, k)
        out = tmp_path / name
        mod.write_gml(str(out / "graph.gml"), nodes, k)
        mod.write_graphviz(str(out / "graph.dot"), nodes, k, subgraph,
                           make_png=False)
        mod.write_lastgraph(str(out / "LastGraph"), nodes, k, subgraph)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == ["LastGraph", "graph.dot", "graph.gml"]
    assert got == want
    assert b"_start" in got["graph.gml"] and b"_oxa347" in got["LastGraph"]


STUB = """#!/bin/sh
echo "$(basename "$0") $*" >> "{log}"
exit {rc}
"""


@pytest.mark.parametrize("rc", [0, 1])
def test_blast_wrappers_match_jax(tmp_path, monkeypatch, rc):
    """make_blast_db and run_blast_filter run the same command lines as the
    JAX package's and report the stub's exit status; without BLAST+ on PATH
    both report False."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "calls.txt"
    for tool in ("makeblastdb", "blastn"):
        (bindir / tool).write_text(STUB.format(log=log, rc=rc))
        (bindir / tool).chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    results = []
    for mod in (xw, jax_xw):
        results.append((
            mod.make_blast_db(["a.fasta", "b.fasta"],
                              str(tmp_path / "db" / "dbReads"), LOG),
            mod.run_blast_filter(str(tmp_path / "db" / "dbReads"), "q.fasta",
                                 "q.out", 3, LOG)))
    assert results[0] == results[1] == (rc == 0, rc == 0)
    calls = log.read_text().splitlines()
    assert len(calls) == 4 and calls[:2] == calls[2:]
    assert calls[1].startswith("blastn -db ") and "-num_threads 3" in calls[1]
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert xw.make_blast_db(["a"], str(tmp_path / "x"), LOG) is False
    assert xw.run_blast_filter("db", "q", "o", 1, LOG) is False
