"""The port's device contraction (ops/contraction_device.py, plain torch, on
the CPU here) against the JAX package's: the reverse complement on codes with
the top bits set, contract_codes_device bit for bit on graphs with cycles,
self-loops, hairpins and tag barriers, the refusals, the same unitig set as
the host sweep, the MC_DEVICE_CONTRACT routing table, and `fmt-visualiser`
byte for byte under MC_DEVICE_CONTRACT=1.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metacherchant_tpu.algo import contraction as JCo
from metacherchant_tpu.ops import contraction_device as JD
from metacherchant_tpu.ops.bfs_device import _revcomp_dev
from metacherchant_tpu_torch.algo import contraction as TCo
from metacherchant_tpu_torch.dna import normalize, reverse_complement
from metacherchant_tpu_torch.ops import contraction_device as TD
from metacherchant_tpu_torch.ops.kmers import fw_codes_of_kmer_strings
from metacherchant_tpu_torch.runner import main as port_main

from torch_fmt_data import fmt_data, run_both, tree  # noqa: F401


@pytest.mark.parametrize("k", [1, 3, 21, 31])
def test_revcomp_matches_jax_on_top_bit_codes(k):
    """Codes whose top used bits (2k-1, 2k-2) are set, and int64 values with
    bit 63 set, where the int64 shifts must act as JAX's uint64 ones."""
    rng = np.random.default_rng(k)
    top = (1 << (2 * k)) - 1 - rng.integers(0, 1 << (2 * k - 2), 500)
    wide = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        2000, dtype=np.int64)
    codes = np.concatenate([top, wide, [0, -1, np.iinfo(np.int64).min,
                                        np.iinfo(np.int64).max]])
    got = TD._revcomp(torch.from_numpy(codes), k).numpy()
    want = np.asarray(_revcomp_dev(jnp.asarray(codes), k))
    assert (codes[:500] >> (2 * k - 2) == 3).all() and (wide < 0).any()
    assert np.array_equal(got, want)


def _hairpin_kmer(rng, k: int) -> str:
    """a + w with w its own reverse complement: an edge u -> rc(u)."""
    p = "".join(rng.choice(list("ACGT"), (k - 1) // 2))
    return "C" + p + reverse_complement(p)


def _graph(k: int, seed: int) -> tuple[list[str], list[str]]:
    """Canonical k-mers (ASCII-lex orientation, as the pictures give them)
    of genome fragments (chains and branches), a circular sequence (a pure
    cycle), a homopolymer (a self-loop) and hairpins; and those last two."""
    rng = np.random.default_rng(seed)
    glen, frag, circ_len = (400, 90, 70) if k > 3 else (12, 6, 5)
    genome = "".join(rng.choice(list("ACGT"), glen))
    seqs = [genome[i:i + frag] for i in rng.integers(0, glen - frag, 6)]
    circ = "".join(rng.choice(list("ACGT"), circ_len))
    special = ["A" * k] + [_hairpin_kmer(rng, k) for _ in range(3)]
    seqs += [circ + circ[:k - 1]] + special
    return sorted({normalize(s[i:i + k]) for s in seqs
                   for i in range(len(s) - k + 1)}), special


@pytest.mark.parametrize("k", [3, 21, 31])
@pytest.mark.parametrize("n_tags", [1, 3])
def test_contract_codes_device_matches_jax(k, n_tags):
    kmers, special = _graph(k, k + n_tags)
    codes = fw_codes_of_kmer_strings(kmers, k)
    tags = np.random.default_rng(k).integers(0, n_tags, codes.size
                                             ).astype(np.int32)
    if n_tags > 1:  # tag runs along the input order, so barriers cut chains
        tags = np.repeat(tags[:codes.size // 4 + 1], 4)[:codes.size]
    got = TD.contract_codes_device(torch.from_numpy(codes),
                                   torch.from_numpy(tags), k)
    want = JD.contract_codes_device(jnp.asarray(codes), jnp.asarray(tags), k)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    U, _, head, dist = (t.numpy() for t in got)
    assert U.size == 2 * len(kmers)
    if k > 3:  # chains; the self-loop and the hairpins are never chained into
        assert dist.max() >= 3
        for s in special + [reverse_complement(x) for x in special]:
            i = int(np.searchsorted(U, fw_codes_of_kmer_strings([s], k)[0]))
            assert U[i] == fw_codes_of_kmer_strings([s], k)[0]
            assert dist[i] == 0 and head[i] == i


def test_even_k_refused_like_jax(monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="odd k"):
        TD.contract_codes_device(torch.zeros(2, dtype=torch.int64),
                                 torch.zeros(2, dtype=torch.int32), 4)
    for mod in (TD, JD):
        with pytest.raises(ValueError):
            mod.contract_device(["ACGT"], 4)


def test_empty_and_single_kmer(monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    assert TD.contract_device([], 21) == []
    km = normalize("ACGTACGTACGTACGTACGTA")
    nodes = TD.contract_device([km], 21)
    assert [(n.seq, n.id) for n in nodes] == \
        [(n.seq, n.id) for n in JD.contract_device([km], 21)]
    assert {normalize(n.seq) for n in nodes} == {km}


def _content(nodes):
    return {(normalize(n.seq), n.color, n.is_gene) for n in nodes
            if not n.deleted}


def _edges(nodes):
    return {frozenset((normalize(n.seq), normalize(m.seq)))
            for n in nodes if not n.deleted
            for m in n.neighbors if not m.deleted}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_unitig_set_as_host_sweep(seed, monkeypatch):
    """Genome fragments (no self-loop or hairpin, where the routes differ by
    design), with a gene barrier; the device route also equals the JAX one
    node for node."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    k = 21
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 400))
    kmers = sorted({normalize(genome[i + j:i + j + k])
                    for i in rng.integers(0, 320, 6) for j in range(80 - k)})
    checker = TCo.gene_kmer_checker([genome[100:160]], k)
    host = TCo.build_node_graph(kmers, k, is_gene=checker)
    TCo.do_merge(host, k)
    dev = TD.contract_device(kmers, k, tag_of=checker)
    assert _content(dev) == _content(host)
    assert _edges(dev) == _edges(host)
    assert any(n.is_gene for n in dev) and len(TCo.alive(host)) > 2
    jdev = JD.contract_device(kmers, k,
                              tag_of=JCo.gene_kmer_checker([genome[100:160]],
                                                           k))
    assert [(n.seq, n.id, n.is_gene, n.color,
             [m.id for m in n.neighbors]) for n in dev] == \
        [(n.seq, n.id, n.is_gene, n.color,
          [m.id for m in n.neighbors]) for n in jdev]


@pytest.mark.parametrize("flag", [None, "0", "1", "yes"])
def test_use_device_contraction_routes_like_jax(flag, monkeypatch):
    for auto_min, n, k in itertools.product((None, "", "50", "500"),
                                            (10, 100, 1000),
                                            (3, 21, 22, 31, 33)):
        for name, value in (("MC_DEVICE_CONTRACT", flag),
                            ("MC_DEVICE_CONTRACT_MIN", auto_min)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        got = TCo.use_device_contraction(n, k)
        assert got == JCo.use_device_contraction(n, k), (flag, auto_min, n, k)
        assert got == (k % 2 == 1 and k <= 31 and (
            flag == "1" or (flag != "0" and bool(auto_min)
                            and n >= int(auto_min))))


@pytest.mark.parametrize("switch", [("MC_DEVICE_CONTRACT", "1"),
                                    ("MC_DEVICE_CONTRACT_MIN", "1")],
                         ids=["forced", "auto-min"])
def test_fmt_visualiser_device_contract_byte_identical_to_jax(
        fmt_data, switch, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.delenv("MC_DEVICE_CONTRACT", raising=False)
    monkeypatch.setenv(*switch)
    got = run_both(fmt_data, "fmt-visualiser", 21, tmp_path)
    monkeypatch.setenv("MC_DEVICE_CONTRACT", "0")
    assert port_main(["-t", "fmt-visualiser", "-k", "21", "-i",
                      str(fmt_data / "bins"), "--ext", "fastq",
                      "-donor", str(fmt_data / "donor.fastq"),
                      "-before", str(fmt_data / "before.fastq"),
                      "-after", str(fmt_data / "after.fastq"),
                      "-o", str(tmp_path / "host"),
                      "--work-dir", str(tmp_path / "wh")]) == 0
    host = tree(tmp_path / "host")

    def segments(blob):
        return sorted((normalize(ln.split("\t")[2]), ln.split("\t")[5])
                      for ln in blob.decode().splitlines()
                      if ln.startswith("S\t"))
    for name in ("donor.gfa", "before.gfa", "after.gfa"):
        assert segments(got[name]) == segments(host[name])
    assert got != host  # record order and strands differ from the sweep
