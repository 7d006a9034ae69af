"""The port's environment-finder-multi against the JAX package: the Jaccard
matrices and the color palettes, the multi-graph join and its merge barrier,
and the CLI on graph.txt files written by the port's own environment-finder
for 2, 3 and 4 environments, with the >256-environments warning, the mixed-k
error and a bad --geneid. Inputs are made from a seed with numpy; outputs
are compared byte for byte (the tolerance is zero).
"""
import math
import os

import numpy as np
import pytest

from metacherchant_tpu.algo import multi as JM
from metacherchant_tpu.algo.contraction import Node as JaxNode
from metacherchant_tpu.io.writers import load_graph_txt as jax_load
from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.algo import multi as TM
from metacherchant_tpu_torch.algo.contraction import Node
from metacherchant_tpu_torch.dna import normalize
from metacherchant_tpu_torch.io.writers import load_graph_txt
from metacherchant_tpu_torch.runner import main as port_main


def _tree(root) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def _env_of(seq: str, k: int) -> dict[str, int]:
    out: dict[str, int] = {}
    for i in range(len(seq) - k + 1):
        s = normalize(seq[i:i + k])
        out[s] = out.get(s, 0) + 1
    return out


def _same(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("graphs", [
    [{"ACG": 3, "CGT": 2}, {"ACG": 3, "CGT": 2}],
    [{"AAA": 2}, {"CCC": 3}],
    [{"AAA": 4, "CCC": 2}, {"AAA": 1}],
    [{}, {"AAA": 1}, {}],
    [{"AAA": 4, "CCC": 2, "GGT": 1}, {"AAA": 1, "GGT": 5}, {"CCC": 7}],
], ids=["identical", "disjoint", "weighted", "empty", "three"])
def test_jaccard_matrices_match_jax(graphs):
    got = TM.jaccard_matrices(graphs)
    want = JM.jaccard_matrices(graphs)
    for g_mat, w_mat in zip(got, want):
        for g_row, w_row in zip(g_mat, w_mat):
            assert all(_same(a, b) for a, b in zip(g_row, w_row))
    assert got[0][0][0] == 0.0 or math.isnan(got[0][0][0])


@pytest.mark.parametrize("n_graphs", [2, 3, 4, 5, 257])
def test_determine_color_matches_jax(n_graphs):
    """Every membership size 0..n of each palette, gene and non-gene; the
    greyscale's %02X overflow at full membership."""
    for is_gene in (False, True):
        for m in range(n_graphs + 1):
            tn, jn = Node("AAA", 0, is_gene), JaxNode("AAA", 0, is_gene)
            tn.graphs = jn.graphs = frozenset(range(m)) if m else None
            assert TM.determine_color(tn, n_graphs) == \
                JM.determine_color(jn, n_graphs)
    full = Node("AAA", 0)
    full.graphs = frozenset(range(4))
    assert TM.determine_color(full, 4) == "#100100100"


def _node_rows(nodes) -> list[tuple]:
    return [(n.id, n.seq, n.rc.id, n.is_gene, n.deleted, n.graphs,
             [m.id for m in n.neighbors]) for n in nodes]


@pytest.mark.parametrize("k,n_graphs", [(5, 2), (7, 3), (11, 4)])
def test_multi_join_matches_jax(k, n_graphs, tmp_path):
    """build_multi_node_graph, multi_merge and both writers: node for node
    and byte for byte, on overlapping pieces of one genome."""
    rng = np.random.default_rng(k)
    g = "".join(rng.choice(list("ACGT"), 300))
    graphs = [_env_of(g[40 * i:40 * i + 140], k) for i in range(n_graphs)]
    for gr in graphs:
        for kmer in list(gr)[::3]:
            gr[kmer] += int(rng.integers(1, 9))
    gene = g[100:130]
    tn = TM.build_multi_node_graph(graphs, k, gene)
    jn = JM.build_multi_node_graph(graphs, k, gene)
    assert _node_rows(tn) == _node_rows(jn)
    TM.multi_merge(tn, k)
    JM.multi_merge(jn, k)
    assert _node_rows(tn) == _node_rows(jn)
    alive = [n for n in tn if not n.deleted]
    assert len(alive) < len(tn) and any(n.is_gene for n in alive)
    for name, mod, nodes in (("t", TM, tn), ("j", JM, jn)):
        mod.write_gfa_multi(str(tmp_path / name / "graph.gfa"), nodes, k,
                            graphs)
        mod.write_seqs_fasta_multi(str(tmp_path / name / "seqs.fasta"), nodes)
        mod.write_jaccard(str(tmp_path / name), ["a", "b", "c", "d"][:n_graphs],
                          graphs)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_load_graph_txt_matches_jax(tmp_path):
    p = tmp_path / "graph.txt"
    p.write_text("ACGTA 3\n\nCCGTA 12\n  TTTTT 1  \n")
    assert load_graph_txt(str(p)) == jax_load(str(p)) == \
        {"ACGTA": 3, "CCGTA": 12, "TTTTT": 1}


@pytest.fixture(scope="module")
def env_files(tmp_path_factory):
    """graph.txt files of one gene written by the port's environment-finder
    (k = 21): all reads at coverage 1, 2 and 3, and the first half of the
    reads at coverage 1."""
    tmp = tmp_path_factory.mktemp("envs")
    rng = np.random.default_rng(11)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    starts = rng.integers(0, 2940, size=500)
    lines = [f"@r{i}\n{g[s:s + 60]}\n+\n{'I' * 60}\n"
             for i, s in enumerate(starts)]
    (tmp / "all.fastq").write_text("".join(lines))
    (tmp / "half.fastq").write_text("".join(lines[:250]))
    (tmp / "gene.fasta").write_text(f">geneA\n{g[1000:1120]}\n")
    files = []
    old = os.environ.get("MC_PLATFORM")
    os.environ["MC_PLATFORM"] = "cpu"
    try:
        for name, reads, cov in (("c1", "all", 1), ("c2", "all", 2),
                                 ("c3", "all", 3), ("h1", "half", 1)):
            assert port_main([
                "-t", "environment-finder", "-k", "21",
                "-i", str(tmp / f"{reads}.fastq"),
                "--seq", str(tmp / "gene.fasta"), "-o", str(tmp / name),
                "--coverage", str(cov), "--maxradius", "60",
                "--work-dir", str(tmp / f"wd_{name}")]) == 0
            files.append(str(tmp / name / "geneA" / "graph.txt"))
    finally:
        if old is None:
            del os.environ["MC_PLATFORM"]
        else:
            os.environ["MC_PLATFORM"] = old
    return files, str(tmp / "gene.fasta")


def _run_both(tmp_path, args: list[str]) -> tuple[int, int]:
    rcs = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        rcs.append(main(["-t", "environment-finder-multi", *args,
                         "-o", str(tmp_path / f"out_{name}"),
                         "--work-dir", str(tmp_path / f"wd_{name}")]))
    return rcs[0], rcs[1]


def _log(tmp_path, name: str) -> str:
    with open(tmp_path / f"wd_{name}" / "log") as fh:
        return fh.read()


@pytest.mark.parametrize("n_env", [2, 3, 4])
def test_cli_matches_jax(n_env, env_files, tmp_path, monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    files, gene = env_files
    assert len({open(f).read() for f in files[:n_env]}) == n_env
    assert _run_both(tmp_path, ["-e", *files[:n_env], "--seq", gene]) == \
        (0, 0)
    got, want = _tree(tmp_path / "out_port"), _tree(tmp_path / "out_jax")
    assert sorted(got) == ["Jacard_alt.txt", "Jacard_sym.txt", "gene.fasta",
                           "graph.gfa", "seqs.fasta"]
    assert got == want
    sym = got["Jacard_sym.txt"].decode().splitlines()
    assert sym[0].startswith("The[31mWarning! symmetric")
    for i in range(n_env):
        assert sym[2 + i].startswith(files[i])
        assert sym[2 + i][len(files[i]):].split()[i] == "0.00"


def test_more_than_256_environments_warn_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    rng = np.random.default_rng(3)
    g = "".join(rng.choice(list("ACGT"), 400))
    files = []
    for i in range(257):
        p = tmp_path / f"e{i}.txt"
        p.write_text("".join(f"{normalize(g[j:j + 9])} {i % 5 + 1}\n"
                             for j in range(i % 50, i % 50 + 8)))
        files.append(str(p))
    gene = tmp_path / "gene.fasta"
    gene.write_text(f">g\n{g[20:40]}\n")
    assert _run_both(tmp_path, ["-e", *files, "--seq", str(gene)]) == (0, 0)
    assert _tree(tmp_path / "out_port") == _tree(tmp_path / "out_jax")
    for name in ("jax", "port"):
        assert "Found more than 256 environments" in _log(tmp_path, name)


def test_mixed_k_fails_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    (tmp_path / "a.txt").write_text("ACGTA 1\nCCGTA 2\n")
    (tmp_path / "b.txt").write_text("ACGTAC 1\n")
    (tmp_path / "gene.fasta").write_text(">g\nACGTACGT\n")
    assert _run_both(tmp_path, ["-e", str(tmp_path / "a.txt"),
                                str(tmp_path / "b.txt"), "--seq",
                                str(tmp_path / "gene.fasta")]) == (1, 1)
    for name in ("jax", "port"):
        assert "K-mers of different lengths encountered: 5 and 6" in \
            _log(tmp_path, name)
        assert not os.path.exists(tmp_path / f"wd_{name}" / "SUCCESS")


@pytest.mark.parametrize("geneid", ["0", "2", "7"])
def test_bad_geneid_fails_like_jax(geneid, tmp_path, monkeypatch):
    """--geneid 0 wraps to the last record as in the JAX package; past the
    end it fails."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    (tmp_path / "a.txt").write_text("ACGTA 1\nCCGTA 2\n")
    (tmp_path / "gene.fasta").write_text(">g\nACGTACGT\n>h\nCCGTAC\n")
    rcs = _run_both(tmp_path, ["-e", str(tmp_path / "a.txt"), "--seq",
                               str(tmp_path / "gene.fasta"), "-g", geneid])
    assert rcs == ((0, 0) if geneid in ("0", "2") else (1, 1))
    if rcs == (1, 1):
        for name in ("jax", "port"):
            assert "Could not load sequence file" in _log(tmp_path, name)
    else:
        assert _tree(tmp_path / "out_port") == _tree(tmp_path / "out_jax")


def test_missing_env_file_fails_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    (tmp_path / "gene.fasta").write_text(">g\nACGTACGT\n")
    assert _run_both(tmp_path, ["-e", str(tmp_path / "nope.txt"), "--seq",
                                str(tmp_path / "gene.fasta")]) == (1, 1)
    for name in ("jax", "port"):
        assert "Couldn't load graph from file" in _log(tmp_path, name)
