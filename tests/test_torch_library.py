"""The port's host library functions against the JAX package's.

The record writers, the string and pair hashes, split_on_n,
count_sequences_host, kmer_key, classify_pairs, reverse_complement_str,
to_clock_like_string and DeviceHashTable.size. Inputs are made from a seed
with numpy and handed to both packages; the tolerance is exact equality
everywhere (files byte for byte, hashes bit for bit, maps key for key).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from metacherchant_tpu import counting as JC
from metacherchant_tpu import dna as JD
from metacherchant_tpu import progress as JP
from metacherchant_tpu.algo import classify as JCL
from metacherchant_tpu.algo import fmt as JF
from metacherchant_tpu.io import readers as JR
from metacherchant_tpu.io import writers as JW
from metacherchant_tpu.ops import contraction_device as JCD
from metacherchant_tpu.ops import hashtable as JHT
from metacherchant_tpu.ops import kmers as JK
from metacherchant_tpu_torch import counting as TC
from metacherchant_tpu_torch import dna as TD
from metacherchant_tpu_torch import progress as TP
from metacherchant_tpu_torch.algo import classify as TCL
from metacherchant_tpu_torch.algo import fmt as TF
from metacherchant_tpu_torch.io import readers as TR
from metacherchant_tpu_torch.io import writers as TW
from metacherchant_tpu_torch.ops import contraction_device as TCD
from metacherchant_tpu_torch.ops import hashtable as THT
from metacherchant_tpu_torch.ops import kmers as TK

ACGT = np.array(list("ACGT"))


def _seqs(rng, n, lo, hi, n_rate=0.0):
    """n random reads of lo..hi bases (0 allowed), N at n_rate."""
    out = []
    for _ in range(n):
        s = ACGT[rng.integers(0, 4, int(rng.integers(lo, hi + 1)))]
        s[rng.random(s.size) < n_rate] = "N"
        out.append("".join(s))
    return out


def _reads(rng, n):
    """(codes, phred) of n reads, empty ones among them, phred 0..80
    (above the 62 clamp)."""
    out = []
    for s in _seqs(rng, n, 0, 40):
        codes = np.clip(TD.CHAR_TO_CODE[np.frombuffer(s.encode(), np.uint8)],
                        0, 3).astype(np.int8)
        phred = rng.integers(0, 81, len(s)).astype(np.int16)
        out.append((codes, phred))
    return out


def _as(pkg_readers, pairs):
    return [pkg_readers.DnaQ(c.copy(), p.copy()) for c, p in pairs]


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("quality", ["illumina", "sanger"])
def test_record_writers_byte_identical(quality, tmp_path):
    rng = np.random.default_rng(5)
    pairs = _reads(rng, 40)
    assert any(c.size == 0 for c, _ in pairs)
    assert any((p > 62).any() for _, p in pairs)
    records = [(f"r{i}", JD.decode(c), p) for i, (c, p) in enumerate(pairs)]
    for mod, tag in ((JW, "j"), (TW, "t")):
        mod.write_fastq(str(tmp_path / tag / "a.fastq"), records, quality)
        mod.write_fasta(str(tmp_path / tag / "a.fasta"),
                        [(n, s) for n, s, _ in records])
        readers = JR if mod is JW else TR
        mod.write_binq(str(tmp_path / tag / "a.binq"), _as(readers, pairs))
        with mod.FastqWriter(str(tmp_path / tag / "w.fastq"), quality) as w:
            dq = _as(readers, pairs)
            w.write(dq[0])
            w.write_many(dq[1:15])
            w.write_many([])
            w.write(dq[15])
            w.write_many(dq[16:])
    for name in ("a.fastq", "a.fasta", "a.binq", "w.fastq"):
        want = _read(tmp_path / "j" / name)
        assert want and _read(tmp_path / "t" / name) == want, name
    # numbering runs on across the calls: @1 .. @40
    heads = _read(tmp_path / "t" / "w.fastq").split(b"\n")[::4]
    assert heads[:-1] == [f"@{i}".encode() for i in range(1, 41)]
    # BINQ round-trips through the port's reader, phred clamped at 62
    back = list(TR.iter_dnaq(str(tmp_path / "t" / "a.binq"), "binq"))
    assert len(back) == len(pairs)
    for (c, p), d in zip(pairs, back):
        assert np.array_equal(d.codes, c)
        assert np.array_equal(d.phred, np.minimum(p, 62))


@pytest.mark.parametrize("k", [1, 21, 33, 55, 64])
def test_string_hashes_bit_equal(k):
    rng = np.random.default_rng(k)
    kmers = ["".join(ACGT[rng.integers(0, 4, k)]) for _ in range(200)]
    for hasher, fn in (("poly", "poly_hash_str"),
                       ("fnv1a", "fnv1a_hash_str")):
        want = [getattr(JK, fn)(s) for s in kmers]
        assert [getattr(TK, fn)(s) for s in kmers] == want
        assert [TK.hash_str(s, hasher) for s in kmers] == want
        assert [JK.hash_str(s, hasher) for s in kmers] == want
        codes = TK.codes_matrix_of_kmer_strings(kmers, k)
        tfw, trc = TK.hash_codes_pair_np(codes, hasher)
        jfw, jrc = JK.hash_codes_pair_np(codes, hasher)
        assert tfw.dtype == jfw.dtype == np.uint64
        assert np.array_equal(tfw, jfw) and np.array_equal(trc, jrc)
        got = TK.hash_codes_np(codes, hasher)
        assert np.array_equal(got, JK.hash_codes_np(codes, hasher))
        assert got.tolist() == want
    if k <= 31:
        assert ([TK.hash_str(s, None) for s in kmers]
                == [JK.hash_str(s, None) for s in kmers])
    with pytest.raises(ValueError):
        TK.hash_str(kmers[0], "md5")


@pytest.mark.parametrize("seq", ["", "N", "NNNN", "NACGT", "ACGTN",
                                 "ACNNGT", "NACNNGTTN",
                                 "ACGTACGT"])
def test_split_on_n_matches_jax(seq):
    codes = TD.encode(seq)
    got, want = TD.split_on_n(codes), JD.split_on_n(JD.encode(seq))
    assert [p.tolist() for p in got] == [p.tolist() for p in want]
    assert all(p.size and (p >= 0).all() for p in got)


def test_split_on_n_random_matches_jax():
    rng = np.random.default_rng(9)
    for s in _seqs(rng, 50, 0, 60, n_rate=0.15):
        got, want = TD.split_on_n(TD.encode(s)), JD.split_on_n(JD.encode(s))
        assert [p.tolist() for p in got] == [p.tolist() for p in want]


@pytest.mark.parametrize("k,hasher", [(5, None), (21, None), (33, "poly"),
                                      (33, "fnv1a"), (21, "poly")])
def test_count_sequences_host_matches_jax(k, hasher):
    rng = np.random.default_rng(k)
    seqs = _seqs(rng, 30, 0, 120, n_rate=0.02)
    got = TC.count_sequences_host(seqs, k, hasher)
    want = JC.count_sequences_host(seqs, k, hasher)
    assert len(got) > 100
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)


def test_small_names_match_jax():
    rng = np.random.default_rng(3)
    for ms in [0, 499, 500, 59_499, 59_500, 3_599_500, 86_399_499,
               360_000_000, *rng.integers(0, 10**9, 50).tolist()]:
        assert TP.to_clock_like_string(ms) == JP.to_clock_like_string(ms)
    assert TP.to_clock_like_string(3_723_000) == "1:02:03"
    f1, f2 = rng.random(64) < 0.5, rng.random(64) < 0.5
    len2 = rng.integers(0, 3, 64)
    got = TCL.classify_pairs(f1, f2, len2)
    want = JCL.classify_pairs(f1, f2, len2)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert np.array_equal(got[1][len2 == 0], ~f1[len2 == 0])
    for k, hasher in ((21, None), (33, "poly"), (33, "fnv1a")):
        for _ in range(20):
            s = "".join(ACGT[rng.integers(0, 4, k)])
            assert TF.kmer_key(s, k, hasher) == JF.kmer_key(s, k, hasher)
            assert (TCD.reverse_complement_str(s)
                    == JCD.reverse_complement_str(s))


def test_hashtable_size_matches_jax():
    """The exact live count after inserts that grow the table (CPU)."""
    rng = np.random.default_rng(4)
    tt = THT.DeviceHashTable(torch.device("cpu"), capacity_log2=6)
    jt = JHT.DeviceHashTable(capacity_log2=6)
    assert tt.size == jt.size == 0
    seen: set[int] = set()
    for _ in range(3):
        keys = rng.integers(0, 300, 256).astype(np.int64)
        keys[rng.random(256) < 0.1] = TK.SENTINEL
        tt.insert_batch(torch.from_numpy(keys))
        jt.insert_batch(jnp.asarray(keys))
        seen.update(keys[keys != TK.SENTINEL].tolist())
        assert tt.size == jt.size == len(seen)
    assert tt.capacity > 64
