"""The port's FMT family against the JAX package: the mutable map view, the
two environment calculators, the color predicates, the hashed regime's
string recovery, the colored picture on the host route, and `fmt-visualiser`
end to end (both packages run in-process through runner.main, outputs
compared byte for byte; test_torch_fmt_tools.py has the other two tools).
Inputs are made from a seed with numpy; the tolerance is zero.
"""
import numpy as np
import pytest

from metacherchant_tpu.algo import fmt as JF
from metacherchant_tpu.counting import (count_sequences_host,
                                        load_present_kmer_strings as jax_lpks)
from metacherchant_tpu.dna import reverse_complement
from metacherchant_tpu.kmer_map import KmerMap as JaxKmerMap
from metacherchant_tpu.ops.kmers import hash_str
from metacherchant_tpu_torch.algo import fmt as TF
from metacherchant_tpu_torch.counting import load_present_kmer_strings
from metacherchant_tpu_torch.kmer_map import KmerMap
from torch_fmt_data import (fmt_data, random_genome, run_both, sample_reads,
                            tree)


def _port_map(jm: JaxKmerMap) -> KmerMap:
    return KmerMap(jm.keys, jm.counts)


# ---------------------------------------------------------------------------
# the calculators and predicates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,hasher", [(5, None), (33, "poly"),
                                      (35, "fnv1a")])
def test_kmermap_get_and_contains_match_jax(k, hasher):
    rng = np.random.default_rng(k)
    g = random_genome(rng, 300)
    jm = count_sequences_host([g, g[:120]], k, hasher)
    tm = _port_map(jm)
    queries = [g[i:i + k] for i in range(0, 200, 7)]
    queries += [random_genome(rng, k) for _ in range(20)]
    keys = np.array([hash_str(q, hasher) for q in queries], np.int64)
    assert [tm.get(int(x)) for x in keys] == [jm.get(int(x)) for x in keys]
    assert np.array_equal(tm.contains(keys), jm.contains(keys))
    assert tm.contains(keys).any() and not tm.contains(keys).all()


@pytest.mark.parametrize("k,hasher", [(5, None), (11, None), (33, "poly")])
def test_kmer_env_flood_matches_jax(k, hasher):
    """The destructive flood, duplicate admissions included: the same
    subgraphs in the same order, and the same zeroed counts after."""
    rng = np.random.default_rng(k + 1)
    g = random_genome(rng, 200)
    seqs = [g, g[50:120] + random_genome(rng, 40), "T" * 20,
            random_genome(rng, 60)]
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
    genome = random_genome(rng, 500)
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
    seqs = [random_genome(rng, 200) for _ in range(4)]
    jbins = [count_sequences_host([s], k, hasher) for s in seqs]
    tbins = [_port_map(b) for b in jbins]
    kmers = sorted({s[i:i + k] for s in seqs for i in range(0, 150, 3)}
                   | {random_genome(rng, k) for _ in range(50)})
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
    genome = random_genome(rng, 400)
    reads = sample_reads(rng, genome, 50, 90) + [random_genome(rng, 70)]
    f = tmp_path / "reads.fasta"
    f.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    jm = count_sequences_host(reads[:40] + [random_genome(rng, 100)], k,
                              hasher)
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
    genome = random_genome(rng, 1500)
    k = 15
    sub = {}
    for s in sample_reads(rng, genome, 60, 60):
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
    got, want = tree(tmp_path / "t"), tree(tmp_path / "j")
    assert sorted(got) == ["pic.gfa", "pic_seqs.fasta"] and got == want
    gfa = got["pic.gfa"].decode()
    for color in ("GREEN", "BLUE", "GREY"):
        assert f"CL:Z:{color}" in gfa
    assert ("_start" in got["pic_seqs.fasta"].decode()) == (id_mode == "min"
                                                            and gene)


# ---------------------------------------------------------------------------
# CLI: fmt-visualiser, byte for byte (the fixture: torch_fmt_data.fmt_data)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,extra", [(21, ()), (55, ()),
                                     (33, ("--hash", "fnv1a"))],
                         ids=["k21", "k55", "k33-fnv1a"])
def test_fmt_visualiser_byte_identical_to_jax(fmt_data, k, extra, tmp_path,
                                              monkeypatch):
    """k = 21 colors the decoded map; k > 31 recovers the strings from the
    reads (load_present_kmer_strings)."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.delenv("MC_DEVICE_CONTRACT", raising=False)
    got = run_both(fmt_data, "fmt-visualiser", k, tmp_path, *extra)
    assert sorted(got) == sorted(f"{n}{s}" for n in ("donor", "before",
                                                     "after")
                                 for s in (".gfa", "_seqs.fasta"))
    after = got["after.gfa"].decode()
    for color in ("RED", "BLUE", "YELLOW"):
        assert f"CL:Z:{color}" in after
