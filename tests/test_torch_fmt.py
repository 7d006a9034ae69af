"""The port's FMT family against the JAX package: the mutable map view, the
two environment calculators, the color predicates, the hashed regime's
string recovery, the colored picture on the host route, and
`fmt-visualiser`, `fmt-visualizer` and `recipient-visualiser` end to end (both
packages run in-process through runner.main, outputs compared byte for byte).
Inputs are made from a seed with numpy; the tolerance is zero.
"""
import os

import numpy as np
import pytest

from metacherchant_tpu.algo import fmt as JF
from metacherchant_tpu.counting import (count_sequences_host,
                                        load_present_kmer_strings as jax_lpks)
from metacherchant_tpu.dna import reverse_complement
from metacherchant_tpu.kmer_map import KmerMap as JaxKmerMap
from metacherchant_tpu.ops.kmers import hash_str
from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.algo import fmt as TF
from metacherchant_tpu_torch.counting import load_present_kmer_strings
from metacherchant_tpu_torch.kmer_map import KmerMap
from metacherchant_tpu_torch.runner import main as port_main

STEMS = ("settle", "not_settle", "stay", "gone", "came_from_donor",
         "came_from_baseline", "came_from_both", "came_itself")


def _port_map(jm: JaxKmerMap) -> KmerMap:
    return KmerMap(jm.keys, jm.counts)


def _tree(root) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def _genome(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), n))


def _reads(rng, g: str, n: int, length: int) -> list[str]:
    out = []
    for _ in range(n):
        i = int(rng.integers(0, len(g) - length))
        r = g[i:i + length]
        out.append(reverse_complement(r) if rng.random() < 0.5 else r)
    return out


def _write_fastq(path, reads) -> str:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


# ---------------------------------------------------------------------------
# the calculators and predicates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,hasher", [(5, None), (33, "poly"),
                                      (35, "fnv1a")])
def test_kmermap_get_and_contains_match_jax(k, hasher):
    rng = np.random.default_rng(k)
    g = _genome(rng, 300)
    jm = count_sequences_host([g, g[:120]], k, hasher)
    tm = _port_map(jm)
    queries = [g[i:i + k] for i in range(0, 200, 7)]
    queries += [_genome(rng, k) for _ in range(20)]
    keys = np.array([hash_str(q, hasher) for q in queries], np.int64)
    assert [tm.get(int(x)) for x in keys] == [jm.get(int(x)) for x in keys]
    assert np.array_equal(tm.contains(keys), jm.contains(keys))
    assert tm.contains(keys).any() and not tm.contains(keys).all()


@pytest.mark.parametrize("k,hasher", [(5, None), (11, None), (33, "poly")])
def test_kmer_env_flood_matches_jax(k, hasher):
    """The destructive flood, duplicate admissions included: the same
    subgraphs in the same order, and the same zeroed counts after."""
    rng = np.random.default_rng(k + 1)
    g = _genome(rng, 200)
    seqs = [g, g[50:120] + _genome(rng, 40), "T" * 20, _genome(rng, 60)]
    jm = count_sequences_host(seqs, k, hasher)
    jv, tv = JF.MutableKmerView(jm), TF.MutableKmerView(_port_map(jm))
    subs = 0
    for s in seqs:
        for i in range(len(s) - k + 1):
            key = hash_str(s[i:i + k], hasher)
            assert tv.get(key) == jv.get(key)
            if jv.get(key) > 0:
                want = JF.kmer_env_subgraph(s[i:i + k], k, jv, hasher)
                got = TF.kmer_env_subgraph(s[i:i + k], k, tv, hasher)
                assert list(got.items()) == list(want.items())
                subs += 1
    assert subs >= 1
    assert np.array_equal(tv.counts, jv.counts) and not tv.counts.any()


@pytest.mark.parametrize("k,hasher,max_radius,max_kmers", [
    (7, None, 10, None), (7, None, 10, 10 ** 9), (7, None, 30, 25),
    (33, "poly", 15, None), (35, "fnv1a", None, 40),
], ids=["exact-vectorized", "exact-fifo", "exact-cap", "k33-poly",
        "k35-fnv1a-cap"])
def test_seq_env_subgraph_matches_jax(k, hasher, max_radius, max_kmers):
    rng = np.random.default_rng(5)
    genome = _genome(rng, 500)
    jm = count_sequences_host([genome, genome[100:300]], k, hasher)
    tm = _port_map(jm)
    absent = "ACGT" * 10  # no 7-mer of it is in the genome
    assert all(jm.get(hash_str(absent[i:i + k], hasher)) < 0
               for i in range(len(absent) - k + 1))
    for seq in (genome[100:140], absent):
        want = JF.seq_env_subgraph(seq, k, jm, hasher, max_radius, max_kmers)
        got = TF.seq_env_subgraph(seq, k, tm, hasher, max_radius, max_kmers)
        assert got == want
        assert (got is None) == (seq == absent)


@pytest.mark.parametrize("k,hasher", [(15, None), (33, "poly")])
def test_color_predicates_match_jax(k, hasher):
    """Scalar == batched in the port, and both == the JAX package."""
    rng = np.random.default_rng(5)
    seqs = [_genome(rng, 200) for _ in range(4)]
    jbins = [count_sequences_host([s], k, hasher) for s in seqs]
    tbins = [_port_map(b) for b in jbins]
    kmers = sorted({s[i:i + k] for s in seqs for i in range(0, 150, 3)}
                   | {_genome(rng, k) for _ in range(50)})
    for jc, tc in ((JF.two_bin_color(k, hasher, *jbins[:2]),
                    TF.two_bin_color(k, hasher, *tbins[:2])),
                   (JF.four_bin_color(k, hasher, *jbins),
                    TF.four_bin_color(k, hasher, *tbins))):
        batch = tc.colors_for(kmers)
        assert list(batch) == [tc(s) for s in kmers]
        assert list(batch) == list(jc.colors_for(kmers))
        assert [tc(s) for s in kmers] == [jc(s) for s in kmers]
        assert len(set(batch)) >= 3


@pytest.mark.parametrize("k,hasher", [(33, "poly"), (55, "fnv1a")])
def test_load_present_kmer_strings_matches_jax(tmp_path, k, hasher):
    """Strings recovered from a hashed map; the map also holds keys the
    reads lack, and the reads windows the map lacks."""
    rng = np.random.default_rng(7)
    genome = _genome(rng, 400)
    reads = _reads(rng, genome, 50, 90) + [_genome(rng, 70)]
    f = tmp_path / "reads.fasta"
    f.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    jm = count_sequences_host(reads[:40] + [_genome(rng, 100)], k, hasher)
    want = jax_lpks([str(f)], k, hasher, jm, rows_per_batch=500)
    got = load_present_kmer_strings([str(f)], k, hasher, _port_map(jm),
                                    rows_per_batch=500)
    assert got == want and len(got) > 100


@pytest.mark.parametrize("gene,merge_on_gene,id_mode", [
    (False, False, "own"), (True, True, "min"), (True, False, "min"),
], ids=["fmt", "seq-env", "gene-flags-only"])
def test_build_colored_picture_host_matches_jax(tmp_path, gene,
                                                merge_on_gene, id_mode,
                                                monkeypatch):
    monkeypatch.delenv("MC_DEVICE_CONTRACT", raising=False)
    rng = np.random.default_rng(11)
    genome = _genome(rng, 1500)
    k = 15
    sub = {}
    for s in _reads(rng, genome, 60, 60):
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            w = min(w, reverse_complement(w))
            sub[w] = sub.get(w, 0) + 1
    pos = count_sequences_host([genome[:900]], k)
    neg = count_sequences_host([genome[700:]], k)
    gene_seq = genome[400:520] if gene else None
    for tag, mod, p, n in (("j", JF, pos, neg),
                           ("t", TF, _port_map(pos), _port_map(neg))):
        nodes = mod.build_colored_picture(
            sub, k, mod.two_bin_color(k, None, p, n), str(tmp_path / tag),
            "pic", gene_sequence=gene_seq, merge_on_gene=merge_on_gene,
            seq_id_mode=id_mode)
        assert sum(not x.deleted for x in nodes) > 10
    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(got) == ["pic.gfa", "pic_seqs.fasta"] and got == want
    gfa = got["pic.gfa"].decode()
    for color in ("GREEN", "BLUE", "GREY"):
        assert f"CL:Z:{color}" in gfa
    assert ("_start" in got["pic_seqs.fasta"].decode()) == (id_mode == "min"
                                                            and gene)


# ---------------------------------------------------------------------------
# CLI: the three FMT tools, byte for byte
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fmt_data(tmp_path_factory):
    """Donor, before and after metagenomes (reads of 80 bp from 400 bp
    genomes, the after one sharing a piece with each of the others), the
    classified read bins of the FMT script and two sequences."""
    tmp = tmp_path_factory.mktemp("fmt")
    rng = np.random.default_rng(11)
    donor, before, new = (_genome(rng, 400) for _ in range(3))
    after = donor[:150] + before[200:350] + new[:100]
    for name, g in (("donor", donor), ("before", before), ("after", after)):
        _write_fastq(tmp / f"{name}.fastq", _reads(rng, g, 60, 80))
    src = {"settle": donor[:200], "not_settle": donor[200:],
           "stay": before[150:], "gone": before[:250],
           "came_from_donor": after[:150], "came_from_baseline": after[150:300],
           "came_from_both": after[100:200], "came_itself": after[300:]}
    bins = tmp / "bins"
    bins.mkdir()
    for stem in STEMS:
        for x in ("1", "2", "s"):
            _write_fastq(bins / f"{stem}_{x}.fastq",
                         _reads(rng, src[stem], 8, 80))
    (tmp / "seqs.fasta").write_text(
        f">s0\n{after[20:130]}\n>s1\n{after[260:380]}\n>s2\n"
        f"{_genome(rng, 90)}\n")
    return tmp


def _fmt_args(data, tool: str, k: int, out, wd, *extra) -> list[str]:
    args = ["-t", tool, "-k", str(k), "-i", str(data / "bins"),
            "--ext", "fastq", "-o", str(out), "--work-dir", str(wd)]
    if tool == "recipient-visualiser":
        return args + ["-after", str(data / "after.fastq"),
                       "--seq", str(data / "seqs.fasta"), *extra]
    return args + ["-donor", str(data / "donor.fastq"),
                   "-before", str(data / "before.fastq"),
                   "-after", str(data / "after.fastq"), *extra]


def _run_both(data, tool, k, tmp_path, *extra) -> dict[str, bytes]:
    for main, tag in ((jax_main, "j"), (port_main, "t")):
        assert main(_fmt_args(data, tool, k, tmp_path / f"o{tag}",
                              tmp_path / f"w{tag}", *extra)) == 0
    got, want = _tree(tmp_path / "ot"), _tree(tmp_path / "oj")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    return got


@pytest.mark.parametrize("k,extra", [(21, ()), (55, ()),
                                     (33, ("--hash", "fnv1a"))],
                         ids=["k21", "k55", "k33-fnv1a"])
def test_fmt_visualiser_byte_identical_to_jax(fmt_data, k, extra, tmp_path,
                                              monkeypatch):
    """k = 21 colors the decoded map; k > 31 recovers the strings from the
    reads (load_present_kmer_strings)."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.delenv("MC_DEVICE_CONTRACT", raising=False)
    got = _run_both(fmt_data, "fmt-visualiser", k, tmp_path, *extra)
    assert sorted(got) == sorted(f"{n}{s}" for n in ("donor", "before",
                                                     "after")
                                 for s in (".gfa", "_seqs.fasta"))
    after = got["after.gfa"].decode()
    for color in ("RED", "BLUE", "YELLOW"):
        assert f"CL:Z:{color}" in after


@pytest.mark.parametrize("k", [21, 33])
def test_fmt_visualizer_byte_identical_to_jax(fmt_data, k, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    got = _run_both(fmt_data, "fmt-visualizer", k, tmp_path)
    for sub in ("donor", "before", "after"):
        assert f"{sub}/comp0.gfa" in got and f"{sub}/comp0_seqs.fasta" in got


@pytest.mark.parametrize("k,extra", [
    (21, ("--maxradius", "40")), (21, ("--maxkmers", "60")),
    (33, ("--maxradius", "30")), (21, ()),
], ids=["k21-radius", "k21-maxkmers", "k33-radius", "k21-default-radius"])
def test_recipient_visualiser_byte_identical_to_jax(fmt_data, k, extra,
                                                    tmp_path, monkeypatch):
    """s2 is absent from the after metagenome: no files for it."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.delenv("MC_DEVICE_CONTRACT", raising=False)
    got = _run_both(fmt_data, "recipient-visualiser", k, tmp_path, *extra)
    assert sorted(got) == sorted(f"after/comp_{i}{s}" for i in (0, 1)
                                 for s in (".gfa", "_seqs.fasta"))
    assert "_start" in got["after/comp_0_seqs.fasta"].decode()
