"""The port's classifier path against the JAX package: the device lookup of
KmerMap, the classifier math (algo/classify.py), the paired-read batches,
the kmers.bin and FASTQ writers, and `kmer-counter` / `reads-classifier`
end to end (both run in-process through runner.main, outputs compared byte
for byte). Inputs are made from a seed with numpy; the tolerance is zero:
classification floats come out of the same numpy operations.
"""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metacherchant_tpu import native as jax_native
from metacherchant_tpu.algo import classify as JC
from metacherchant_tpu.counting import count_sequences_host
from metacherchant_tpu.io import writers as JW
from metacherchant_tpu.io.readers import DnaQ as JaxDnaQ
from metacherchant_tpu.kmer_map import KmerMap as JaxKmerMap, _lookup_sorted
from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.algo import classify as TC
from metacherchant_tpu_torch.io import writers as TW
from metacherchant_tpu_torch.io.readers import DnaQ
from metacherchant_tpu_torch.kmer_map import KmerMap
from metacherchant_tpu_torch.runner import main as port_main

CPU = torch.device("cpu")
BINS = ("found_1", "found_2", "not_found_1", "not_found_2", "found_s",
        "not_found_s")


def _top_bit_map(seed: int, n: int = 5000):
    """Keys over all of int64 (top bit set on about half) with counts."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(np.iinfo(np.int64).min,
                                  np.iinfo(np.int64).max, n, dtype=np.int64))
    counts = rng.integers(1, 40000, keys.size)
    jm = JaxKmerMap.from_pairs(keys, counts)
    return rng, jm, KmerMap(jm.keys, jm.counts)


def _queries(rng, keys: np.ndarray) -> np.ndarray:
    """Present keys, absent keys of both signs, and the int64 extremes."""
    absent = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                          3000, dtype=np.int64)
    ext = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0],
                   np.int64)
    q = np.concatenate([keys[::2], absent, ext, keys[-1:], keys[:1]])
    return rng.permutation(q)


def test_lookup_device_matches_jax_lookup_sorted():
    rng, jm, tm = _top_bit_map(1)
    assert (tm.keys < 0).sum() > 1000
    q = _queries(rng, tm.keys)
    got = tm.lookup_device(torch.from_numpy(q))
    want = np.asarray(_lookup_sorted(jnp.asarray(jm.keys),
                                     jnp.asarray(jm.counts), jnp.asarray(q)))
    assert got.dtype == torch.int32 and got.device == CPU
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), tm.get_many(q))
    assert (want == -1).sum() >= 3000 and (want > 0).sum() >= 2500
    q2 = q[:1000].reshape(40, 25)
    assert np.array_equal(tm.lookup_device(torch.from_numpy(q2)).numpy(),
                          np.asarray(jm.lookup_device(jnp.asarray(q2))))


@pytest.mark.parametrize("order", ["sorted", "shuffled", "repeated"])
def test_from_pairs_matches_jax(order):
    """Sorted distinct keys (a kmer-counter dump) make the map as they are;
    any other order is sorted and its repeats summed, as in JAX."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(-2**62, 2**62, 500, dtype=np.int64))
    counts = rng.integers(1, 40000, keys.size).astype(np.int32)
    if order == "shuffled":
        perm = rng.permutation(keys.size)
        keys, counts = keys[perm], counts[perm]
    elif order == "repeated":
        keys, counts = np.concatenate([keys, keys[:50]]), \
            np.concatenate([counts, counts[:50]])
    got, want = KmerMap.from_pairs(keys, counts), \
        JaxKmerMap.from_pairs(keys, counts)
    for a, b in ((got.keys, want.keys), (got.counts, want.counts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_lookup_device_empty_map():
    jm = JaxKmerMap(np.empty(0, np.int64), np.empty(0, np.int32))
    tm = KmerMap(jm.keys, jm.counts)
    q = np.array([0, -5, 7, np.iinfo(np.int64).min], np.int64)
    got = tm.lookup_device(torch.from_numpy(q))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jm.lookup_device(
        jnp.asarray(q))))
    assert np.array_equal(got.numpy(), np.full(4, -1))


def test_probe_table_with_top_bit_keys_matches_jax():
    rng, jm, tm = _top_bit_map(2, 20000)
    q = _queries(rng, tm.keys)
    want = jm.get_many(q)
    assert np.array_equal(tm.get_many(q), want)  # the sorted search
    tm._probe_table()
    assert np.array_equal(tm.get_many(q), want)  # the probe table


def test_device_arrays_built_once_across_threads():
    """Classifier threads share one map: concurrent first calls must end up
    with one cached copy per device."""
    _, _, tm = _top_bit_map(3)
    seen = []
    barrier = threading.Barrier(8)

    def work():
        barrier.wait(timeout=30)
        seen.append(tm.device_arrays(CPU))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and len(seen) == 8
    assert all(s[0] is seen[0][0] and s[1] is seen[0][1] for s in seen)
    assert np.array_equal(seen[0][0].numpy(), tm.keys)


@pytest.mark.parametrize("hasher", [None, "poly", "fnv1a"])
def test_rolling_keys_np_matches_jax(hasher):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, (50, 120)).astype(np.int32)
    for k in ((15, 31) if hasher is None else (21, 33, 63)):
        got = TC.rolling_keys_np(codes, k, hasher)
        assert np.array_equal(got, JC.rolling_keys_np(codes, k, hasher))
    assert TC.rolling_keys_np(codes[:, :10], 15, hasher).shape == (50, 0)


def _classify_setup(k: int, hasher: str | None, seed: int = 11):
    """A genome counted three times, and reads: in-graph (some with one
    substitution at a base of low quality), random, chimeric, short, with
    N bases."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 1500))
    jm = count_sequences_host([genome] * 3, k, hasher)
    reads, phreds = [], []
    for i in range(60):
        s, ln = int(rng.integers(0, 1400)), int(rng.integers(10, 90))
        r = list(genome[s:s + ln])
        ph = np.full(len(r), 30, np.int16)
        if i % 4 == 0 and len(r) > 20:
            p = int(rng.integers(0, len(r)))
            r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
            ph[p] = 3
        if i % 9 == 0 and len(r) > 30:
            r[5] = "N"
        reads.append("".join(r))
        phreds.append(ph)
    for _ in range(30):
        ln = int(rng.integers(20, 90))
        reads.append("".join(rng.choice(list("ACGT"), ln)))
        phreds.append(np.full(ln, 30, np.int16))
    for _ in range(20):
        s = int(rng.integers(0, 1400))
        reads.append(genome[s:s + 30] + "".join(rng.choice(list("ACGT"), 30)))
        phreds.append(np.full(60, 30, np.int16))
    batches = []
    for cls in (JaxDnaQ, DnaQ):
        dnaqs = []
        for r, ph in zip(reads, phreds):
            d = cls.from_string(r, 30)
            d.phred[:] = np.where(d.phred == 0, 0, ph)
            dnaqs.append(d)
        batches.append(dnaqs)
    jb = JC.ReadBatch.from_dnaqs(batches[0])
    tb = TC.ReadBatch.from_dnaqs(batches[1])
    for name in ("codes", "lengths", "phred"):
        assert np.array_equal(getattr(jb, name), getattr(tb, name))
    return jm, KmerMap(jm.keys, jm.counts), jb, tb


@pytest.mark.parametrize("device_classify", ["", "1"], ids=["host", "device"])
@pytest.mark.parametrize("corr", [False, True], ids=["plain", "correction"])
@pytest.mark.parametrize("z,thr", [(1.0, 0.9), (1.96, 0.5)])
@pytest.mark.parametrize("k,hasher", [(15, None), (33, "poly"),
                                      (21, "fnv1a")])
def test_find_reads_matches_jax(k, hasher, z, thr, corr, device_classify,
                                monkeypatch):
    """The JAX side runs its host coverage; the port's device route runs on
    the CPU here (MC_PLATFORM=cpu)."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    jm, tm, jb, tb = _classify_setup(k, hasher)
    monkeypatch.delenv("MC_DEVICE_CLASSIFY", raising=False)
    want = JC.find_reads(jb, jm, k, hasher, z, thr, corr)
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", device_classify)
    got = TC.find_reads(tb, tm, k, hasher, z, thr, corr)
    assert got.dtype == bool and np.array_equal(got, want)
    assert 10 < want.sum() < want.size - 10


def test_correction_recovers_single_error():
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), 400))
    jm = count_sequences_host([genome], 15)
    tm = KmerMap(jm.keys, jm.counts)
    d = DnaQ.from_string(genome[50:110], 30)
    d.codes[20] = (d.codes[20] + 1) % 4
    d.phred[20] = 2
    batch = TC.ReadBatch.from_dnaqs([d])
    assert not TC.find_reads(batch, tm, 15, None, 1.0, 0.9)[0]
    assert TC.find_reads(batch, tm, 15, None, 1.0, 0.9, True)[0]


@pytest.mark.parametrize("value,routed", [("", False), ("0", False),
                                          ("1", True), ("yes", True)])
def test_device_classify_switch(value, routed, monkeypatch):
    """Unset, "" and "0" keep the host coverage (the JAX package routes on
    any non-empty value, "0" included; outputs are equal either way)."""
    jm, tm, jb, tb = _classify_setup(15, None)
    calls = []
    real = TC._window_counts_device
    monkeypatch.setattr(TC, "_window_counts_device",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", value)
    got = TC.find_reads(tb, tm, 15, None, 1.0, 0.9)
    assert bool(calls) == routed and TC.device_classify() == routed
    assert np.array_equal(got, JC.find_reads(jb, jm, 15, None, 1.0, 0.9))


def test_device_coverage_equals_host_coverage(monkeypatch):
    """Every window's count, then the window sums, of the device route
    equal the host route's."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    for k, hasher in ((15, None), (33, "poly"), (33, "fnv1a")):
        _, tm, _, tb = _classify_setup(k, hasher)
        host_cov = TC._window_counts_host(tb, tm, k, hasher)
        dev_cov = TC._window_counts_device(tb, tm, k, hasher).numpy()
        valid = (np.arange(host_cov.shape[1])[None, :]
                 < (tb.lengths - k + 1)[:, None])
        assert dev_cov.shape == host_cov.shape
        assert np.array_equal(dev_cov[valid], host_cov[valid])
        assert (host_cov[valid] > 0).any()
        monkeypatch.setenv("MC_DEVICE_CLASSIFY", "")
        host = TC._coverage(tb, tm, k, hasher)
        monkeypatch.setenv("MC_DEVICE_CLASSIFY", "1")
        dev = TC._coverage(tb, tm, k, hasher)
        assert dev.dtype == host.dtype == np.int64
        assert np.array_equal(dev, host)
        # the sums are those of the valid windows
        masked = np.where(valid, host_cov, 0)
        assert np.array_equal(host[0], masked.sum(1))
        assert np.array_equal(host[1], (masked > 0).sum(1))


def test_found_stats_match_jax():
    for counts in ((3, 1, 2, 5), (0, 0, 0, 0), (4, 0, 0, 0)):
        a, b = TC.FoundStats(*counts), JC.FoundStats(*counts)
        for prop in ("total", "found", "not_found", "paired",
                     "quality_found", "quality_not_found"):
            x, y = getattr(a, prop), getattr(b, prop)
            assert x == y or (np.isnan(x) and np.isnan(y))


def _write_pair(tmp_path, seed: int, n1: int, n2: int):
    """r1 and r2 FASTQ of varying lengths with N bases and Sanger qualities;
    r2 shorter, so the tail of r1 pairs with empty mates."""
    rng = np.random.default_rng(seed)
    paths = []
    for name, n in (("r1", n1), ("r2", n2)):
        p = tmp_path / f"{name}.fastq"
        with open(p, "w") as f:
            for i in range(n):
                ln = int(rng.integers(1, 120))
                r = "".join(rng.choice(list("ACGTN"), ln,
                                       p=[.245] * 4 + [.02]))
                q = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, ln))
                f.write(f"@{name}_{i}\n{r}\n+\n{q}\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("native_io", ["1", "0"])
@pytest.mark.parametrize("single", [False, True], ids=["paired", "single"])
def test_iter_read_batch_pairs_matches_jax(tmp_path, native_io, single,
                                           monkeypatch):
    monkeypatch.setenv("MC_NATIVE_IO", native_io)
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    files = _write_pair(tmp_path, 3, 700, 450)[:1 if single else 2]
    got = list(TC.iter_read_batch_pairs(files, 256))
    want = list(JC.iter_read_batch_pairs(files, 256))
    assert len(got) == len(want) == 3
    for gp, wp in zip(got, want):
        for g, w in zip(gp, wp):
            for name in ("codes", "lengths", "phred"):
                assert np.array_equal(getattr(g, name), getattr(w, name))


def test_fastq_blob_writer_matches_jax(tmp_path):
    """Multi-digit record numbers, empty reads, phred clamping, numbering
    across calls."""
    rng = np.random.default_rng(7)
    dnaqs = []
    for i in range(250):
        n = int(rng.integers(0, 40)) if i % 17 else 0
        dnaqs.append(JaxDnaQ(rng.integers(0, 4, n).astype(np.int8),
                             rng.integers(0, 80, n).astype(np.int16)))
    b = JC.ReadBatch.from_dnaqs(dnaqs)
    want = tmp_path / "want.fastq"
    with JW.FastqWriter(str(want)) as w:
        w.write_many(dnaqs[:100])
        w.write_many(dnaqs[100:])
    got = tmp_path / "got.fastq"
    with TW.FastqWriter(str(got)) as w:
        w.write_batch(b.codes, b.phred, b.lengths, np.arange(100))
        w.write_batch(b.codes, b.phred, b.lengths, np.empty(0, np.int64))
        w.write_batch(b.codes, b.phred, b.lengths, np.arange(100, 250))
    assert got.read_bytes() == want.read_bytes()
    same = np.arange(3, 40)  # uniform-length fast path
    lens = np.full(b.lengths.shape, 12, np.int32)
    assert TW.format_fastq_blob(b.codes, b.phred, lens, same, 95, 33) == \
        JW.format_fastq_blob(b.codes, b.phred, lens, same, 95, 33)


@pytest.mark.parametrize("threshold", [0, 2])
def test_kmers_bin_round_trip_matches_jax(tmp_path, threshold):
    _, jm, _ = _top_bit_map(8)
    counts = np.random.default_rng(8).integers(1, 5, len(jm))
    n = TW.write_kmers_bin(str(tmp_path / "t.kmers.bin"),
                           str(tmp_path / "t.stat.txt"), jm.keys, counts,
                           threshold)
    assert n == JW.write_kmers_bin(str(tmp_path / "j.kmers.bin"),
                                   str(tmp_path / "j.stat.txt"), jm.keys,
                                   counts, threshold)
    for ext in ("kmers.bin", "stat.txt"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    for thr in (0, 3):
        for got, want in zip(TW.read_kmers_bin(str(tmp_path / "j.kmers.bin"),
                                               thr),
                             JW.read_kmers_bin(str(tmp_path / "j.kmers.bin"),
                                               thr)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_kmers_bin_read_in_chunks_matches_jax(tmp_path, monkeypatch):
    """The port reads a dump a chunk of records at a time; chunks of 7
    records, the last one short, give JAX's arrays."""
    monkeypatch.setattr(TW, "KMERS_BIN_CHUNK", 7)
    _, jm, _ = _top_bit_map(8)
    counts = np.random.default_rng(9).integers(1, 5, len(jm))
    path = str(tmp_path / "j.kmers.bin")
    JW.write_kmers_bin(path, str(tmp_path / "j.stat.txt"), jm.keys, counts)
    assert len(jm) % 7
    for thr in (0, 3):
        for got, want in zip(TW.read_kmers_bin(path, thr),
                             JW.read_kmers_bin(path, thr)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# CLI: kmer-counter and reads-classifier, byte for byte
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def metagenomes(tmp_path_factory):
    """Graph reads (A: 300 reads of 80 bp from a 2 kbp genome, with N runs)
    and reads to classify: paired, 60 in-graph (some with one low-quality
    substitution), 40 random, r2 shorter than r1."""
    tmp = tmp_path_factory.mktemp("classify")
    rng = np.random.default_rng(9)
    genome = "".join(rng.choice(list("ACGT"), 2000))
    with open(tmp / "graph.fastq", "w") as f:
        for i in range(300):
            s = int(rng.integers(0, 1920))
            r = genome[s:s + 80]
            if i % 13 == 0:
                r = r[:30] + "NN" + r[32:]
            f.write(f"@g{i}\n{r}\n+\n{'I' * 80}\n")
    mates = []
    for i in range(100):
        if i < 60:
            s, ln = int(rng.integers(0, 1900)), int(rng.integers(40, 100))
            r = list(genome[s:s + ln])
            q = ["I"] * len(r)
            if i % 3 == 0:
                p = int(rng.integers(0, len(r)))
                r[p] = "ACGT"[("ACGT".index(r[p]) + 2) % 4]
                q[p] = "#"
            mates.append(("".join(r), "".join(q)))
        else:
            ln = int(rng.integers(40, 100))
            mates.append(("".join(rng.choice(list("ACGT"), ln)), "I" * ln))
    order = rng.permutation(100)
    for name, idx in (("r1", order), ("r2", order[::-1][:85])):
        with open(tmp / f"{name}.fastq", "w") as f:
            for j, i in enumerate(idx):
                f.write(f"@{name}_{j}\n{mates[i][0]}\n+\n{mates[i][1]}\n")
    return tmp


def _tree(root) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def _stats(wd) -> list[str]:
    """The classifier's stats block and graph size, without timestamps."""
    with open(os.path.join(wd, "log")) as fh:
        return [ln.split(": ", 1)[1] for ln in fh
                if "|\t" in ln or "Hashtable size" in ln or "hash function"
                in ln]


@pytest.mark.parametrize("k,extra", [
    (21, ()), (55, ()), (21, ("--forcehash", "--hash", "fnv1a", "-b", "1")),
], ids=["k21", "k55", "k21-forcehash-fnv1a-threshold"])
def test_kmer_counter_byte_identical_to_jax(metagenomes, k, extra, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    g = str(metagenomes / "graph.fastq")
    for main, tag in ((jax_main, "j"), (port_main, "t")):
        assert main(["-t", "kmer-counter", "-k", str(k), "-i", g,
                     "-o", str(tmp_path / f"o{tag}"),
                     "--work-dir", str(tmp_path / f"w{tag}"), *extra]) == 0
    got, want = _tree(tmp_path / "ot"), _tree(tmp_path / "oj")
    assert sorted(got) == ["graph.kmers.bin", "graph.stat.txt"]
    assert got == want and len(got["graph.kmers.bin"]) > 1000


def test_kmer_counter_default_output_dir(metagenomes, tmp_path, monkeypatch):
    """Without -o the dump goes to <work-dir>/kmers (a lazy default)."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    assert port_main(["-t", "kmer-counter", "-k", "21",
                      "-i", str(metagenomes / "graph.fastq"),
                      "--work-dir", str(tmp_path / "wd")]) == 0
    assert (tmp_path / "wd" / "kmers" / "graph.kmers.bin").stat().st_size


@pytest.fixture(scope="module")
def jax_classified(metagenomes, tmp_path_factory):
    """The JAX package's reads-classifier run for a case (graph from reads
    or from a kmers.bin its own kmer-counter wrote), made once per case:
    (graph input, bin files, stats lines)."""
    runs = {}

    def run(source, k, extra, reads):
        key = (source, k, extra, reads)
        if key not in runs:
            tmp = tmp_path_factory.mktemp("jax_classified")
            graph = str(metagenomes / "graph.fastq")
            if source == "jax-bin":
                assert jax_main(["-t", "kmer-counter", "-k", str(k),
                                 "-i", graph, "-o", str(tmp / "bin"),
                                 "--work-dir", str(tmp / "wbin")]) == 0
                graph = str(tmp / "bin" / "graph.kmers.bin")
            assert jax_main(["-t", "reads-classifier", "-k", str(k),
                             "-i", graph, "-r", *reads, "-o", str(tmp / "o"),
                             "--work-dir", str(tmp / "w"), *extra]) == 0
            runs[key] = (graph, _tree(tmp / "o"), _stats(tmp / "w"))
        return runs[key]

    return run


@pytest.mark.parametrize("source,k,extra,single", [
    ("reads", 21, (), False),
    ("reads", 21, (), True),
    ("jax-bin", 21, (), False),
    ("jax-bin", 21, ("--correction",), False),
    ("reads", 21, ("--interval95", "--found-threshold", "70"), False),
    ("reads", 33, ("--hash", "fnv1a"), False),
    ("jax-bin", 55, (), True),
], ids=["reads", "reads-single", "bin", "bin-correction",
        "reads-interval95", "k33-fnv1a", "k55-bin-single"])
@pytest.mark.parametrize("device_classify", ["", "1"], ids=["host", "device"])
def test_reads_classifier_byte_identical_to_jax(
        metagenomes, jax_classified, source, k, extra, single,
        device_classify, tmp_path, monkeypatch):
    """Graph from reads or from a kmers.bin written by the JAX kmer-counter;
    the JAX side classifies on the host, the port by default and under
    MC_DEVICE_CLASSIFY."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    reads = (str(metagenomes / "r1.fastq"),)
    if not single:
        reads += (str(metagenomes / "r2.fastq"),)
    graph, want, want_log = jax_classified(source, k, extra, reads)
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", device_classify)
    assert port_main(["-t", "reads-classifier", "-k", str(k), "-i", graph,
                      "-r", *reads, "-o", str(tmp_path / "o"),
                      "--work-dir", str(tmp_path / "w"), *extra]) == 0
    got, got_log = _tree(tmp_path / "o"), _stats(tmp_path / "w")
    assert sorted(got) == sorted(f"{b}.fastq" for b in BINS)
    assert got == want
    assert got_log == want_log and len(got_log) >= 10
    found = sum(got[f"{b}.fastq"].count(b"\n+\n") for b in BINS[::2])
    not_found = sum(got[f"{b}.fastq"].count(b"\n+\n") for b in BINS[1::2])
    assert found >= 10 and not_found >= 10


def test_reads_classifier_default_output_dir(metagenomes, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    assert port_main(["-t", "reads-classifier", "-k", "21",
                      "-i", str(metagenomes / "graph.fastq"),
                      "-r", str(metagenomes / "r1.fastq"),
                      "--work-dir", str(tmp_path / "wd")]) == 0
    out = tmp_path / "wd" / "reads_classifier"
    assert sorted(os.listdir(out)) == sorted(f"{b}.fastq" for b in BINS)


@pytest.mark.parametrize("device_classify", ["", "1"], ids=["host", "device"])
def test_classify_pool_builds_only_the_lookup_it_probes(
        metagenomes, device_classify, monkeypatch):
    """The pool's workers share one map: the lookup they probe (the host
    probe table, or the map's copy on the device under MC_DEVICE_CLASSIFY)
    is built before the first task, and the other one never."""
    from metacherchant_tpu_torch.counting import count_kmers_host
    from metacherchant_tpu_torch.tools import reads_classifier as RC
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_CLASSIFY_THREADS", "2")
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", device_classify)
    kmap = count_kmers_host([str(metagenomes / "graph.fastq")], 21)
    seen = []
    real = RC.find_reads

    def spy(*args):
        seen.append((hasattr(kmap, "_ptable"), bool(kmap._device)))
        return real(*args)

    monkeypatch.setattr(RC, "find_reads", spy)
    files = [str(metagenomes / "r1.fastq"), str(metagenomes / "r2.fastq")]
    found = [f1.sum() + f2.sum() for _, _, f1, f2 in RC._classified_stream(
        files, kmap, 21, None, 1.0, 0.9, False)]
    on_device = device_classify == "1"
    assert len(seen) == 2 and sum(found) > 0
    assert set(seen) == {(not on_device, on_device)}
    assert hasattr(kmap, "_ptable") != on_device
    assert bool(kmap._device) == on_device


@pytest.mark.parametrize("device_classify", ["", "1"], ids=["host", "device"])
def test_classifier_lets_go_of_the_host_map_on_the_device_route(
        metagenomes, device_classify, tmp_path, monkeypatch):
    """Under MC_DEVICE_CLASSIFY the job's map lives on the device alone
    once copied there; the host route keeps its arrays and probe table."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", device_classify)
    released = []
    real = KmerMap.release_host
    monkeypatch.setattr(KmerMap, "release_host",
                        lambda self: released.append(bool(self._device))
                        or real(self))
    assert port_main(["-t", "reads-classifier", "-k", "21",
                      "-i", str(metagenomes / "graph.fastq"),
                      "-r", str(metagenomes / "r1.fastq"),
                      str(metagenomes / "r2.fastq"),
                      "-o", str(tmp_path / "o"),
                      "--work-dir", str(tmp_path / "w")]) == 0
    assert released == ([True] if device_classify else [])


def test_classify_pool_puts_one_batch_on_the_device_at_a_time(
        metagenomes, monkeypatch):
    """The pool's workers take turns on the device: one batch's keys and
    lookups at a time, so the job's device peak does not follow the
    workers' timing; the found reads are those of one worker."""
    import time
    from metacherchant_tpu_torch.counting import count_kmers_host
    from metacherchant_tpu_torch.tools import reads_classifier as RC
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", "1")
    monkeypatch.setattr(RC, "CLASSIFY_BATCH", 16)
    kmap = count_kmers_host([str(metagenomes / "graph.fastq")], 21)
    files = [str(metagenomes / "r1.fastq"), str(metagenomes / "r2.fastq")]

    def found(threads):
        monkeypatch.setenv("MC_CLASSIFY_THREADS", threads)
        return [np.concatenate([f1, f2]) for _, _, f1, f2 in
                RC._classified_stream(files, kmap, 21, None, 1.0, 0.9, False)]

    one = found("1")
    active, most = [0], [0]
    lock = threading.Lock()
    real = KmerMap.lookup_device

    def lookup(self, query):
        with lock:
            active[0] += 1
            most[0] = max(most[0], active[0])
        time.sleep(0.005)
        try:
            return real(self, query)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(KmerMap, "lookup_device", lookup)
    pooled = found("4")
    assert len(one) >= 4 and most[0] == 1
    assert all(np.array_equal(a, b) for a, b in zip(one, pooled))


# ---------------------------------------------------------------------------
# triple-reads-classifier and seq-cov
# ---------------------------------------------------------------------------

TRIPLE_BINS = tuple(f"{v}_{x}" for v in ("found", "half_found", "not_found")
                    for x in ("1", "2", "s"))


@pytest.mark.parametrize("device_classify", ["", "1"], ids=["host", "device"])
@pytest.mark.parametrize("k,hasher", [(15, None), (33, "poly"),
                                      (21, "fnv1a")])
def test_triple_helpers_match_jax(k, hasher, device_classify, monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    jm, tm, jb, tb = _classify_setup(k, hasher)
    monkeypatch.delenv("MC_DEVICE_CLASSIFY", raising=False)
    want = JC.batch_widths(jb, jm, k, hasher)
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", device_classify)
    got = TC.batch_widths(tb, tm, k, hasher)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (TC.FOUND, TC.HALF_FOUND, TC.NOT_FOUND) == \
        (JC.FOUND, JC.HALF_FOUND, JC.NOT_FOUND)
    rng = np.random.default_rng(k)
    found = TC.find_reads(tb, tm, k, hasher, 1.0, 0.9)
    for half in (0.4, 0.7):
        p1 = TC.triple_verdict_pass1(found, got, half)
        assert np.array_equal(p1, JC.triple_verdict_pass1(found, got, half))
        assert set(p1.tolist()) == {0, 1, 2}
        pass1 = rng.integers(0, 3, found.size).astype(np.int8)
        p2 = TC.triple_verdict_pass2(found, got, pass1, half)
        want2 = JC.triple_verdict_pass2(found, got, pass1, half)
        assert p2.dtype == want2.dtype and np.array_equal(p2, want2)


@pytest.fixture(scope="module")
def triple_graphs(metagenomes, tmp_path_factory):
    """kmers.bin dumps of the graph reads at k = 21 and 33, written by the
    JAX kmer-counter."""
    tmp = tmp_path_factory.mktemp("triple_graphs")
    dumps = {}
    for k in (21, 33):
        assert jax_main(["-t", "kmer-counter", "-k", str(k),
                         "-i", str(metagenomes / "graph.fastq"),
                         "-o", str(tmp / f"k{k}"),
                         "--work-dir", str(tmp / f"w{k}")]) == 0
        dumps[k] = str(tmp / f"k{k}" / "graph.kmers.bin")
    return dumps


@pytest.mark.parametrize("source,extra,single", [
    ("reads", (), False), ("bins", (), False), ("reads", (), True),
    ("bins", ("--correction", "--interval95", "--half-threshold", "30"),
     False),
], ids=["reads", "bins", "reads-single", "bins-correction-interval95"])
@pytest.mark.parametrize("device_classify", ["", "1"], ids=["host", "device"])
def test_triple_reads_classifier_byte_identical_to_jax(
        metagenomes, triple_graphs, source, extra, single, device_classify,
        tmp_path, monkeypatch):
    """k = 21 then k2 = 33 (the hashed regime); graphs from the reads (-i)
    or from kmers.bin dumps (-ik1, -ik2). The JAX side classifies on the
    host, the port by default and under MC_DEVICE_CLASSIFY."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    reads = [str(metagenomes / "r1.fastq")]
    if not single:
        reads.append(str(metagenomes / "r2.fastq"))
    if source == "reads":
        graph = ["-i", str(metagenomes / "graph.fastq")]
    else:
        graph = ["-ik1", triple_graphs[21], "-ik2", triple_graphs[33]]
    for main, tag, dc in ((jax_main, "j", ""),
                          (port_main, "t", device_classify)):
        monkeypatch.setenv("MC_DEVICE_CLASSIFY", dc)
        assert main(["-t", "triple-reads-classifier", "-k", "21",
                     "-k2", "33", *graph, "-r", *reads,
                     "-o", str(tmp_path / f"o{tag}"),
                     "--work-dir", str(tmp_path / f"w{tag}"), *extra]) == 0
    got, want = _tree(tmp_path / "ot"), _tree(tmp_path / "oj")
    assert sorted(got) == sorted(f"{b}.fastq" for b in TRIPLE_BINS)
    assert got == want
    assert _stats(tmp_path / "wt") == _stats(tmp_path / "wj")
    for b in ("found_1", "not_found_1", "found_s", "not_found_s"):
        if not single or b.endswith("_s"):
            assert got[f"{b}.fastq"].count(b"\n+\n") >= 3, b


def test_triple_reads_classifier_refuses_k2_not_above_k(metagenomes,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    assert port_main(["-t", "triple-reads-classifier", "-k", "31",
                      "-k2", "31", "-i", str(metagenomes / "graph.fastq"),
                      "-r", str(metagenomes / "r1.fastq"),
                      "--work-dir", str(tmp_path / "wd")]) == 1
    with open(tmp_path / "wd" / "log") as fh:
        assert "k2 should be greater than k" in fh.read()


def _seq_cov_inputs(metagenomes, tmp_path) -> tuple[list[str], str]:
    """Four bins (graph reads, r1, r2, and the graph reads again) and
    sequences: pieces of the graph reads, a random one, one with an N, and
    sequences of every length from 0 to 15."""
    rng = np.random.default_rng(13)
    with open(metagenomes / "graph.fastq") as fh:
        graph_reads = fh.read().splitlines()[1::4]
    seqs = [graph_reads[1], graph_reads[5][:70] + graph_reads[9],
            "".join(rng.choice(list("ACGT"), 90)),
            graph_reads[3][:40] + "N" + graph_reads[3][41:]]
    seqs += ["".join(rng.choice(list("ACGT"), n)) for n in range(16)]
    path = tmp_path / "seqs.fasta"
    path.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    bins = [str(metagenomes / f) for f in ("graph.fastq", "r1.fastq",
                                           "r2.fastq", "graph.fastq")]
    return bins, str(path)


def _seq_cov_args(bins, seqs, k, out, wd, *extra) -> list[str]:
    return ["-t", "seq-cov", "-k", str(k), "--from-donor", bins[0],
            "--from-before", bins[1], "--from-both", bins[2],
            "--itself", bins[3], "-r", seqs, "-o", str(out),
            "--work-dir", str(wd), *extra]


@pytest.mark.parametrize("k,extra", [(21, ()), (33, ()),
                                     (33, ("--hash", "fnv1a"))],
                         ids=["k21", "k33", "k33-fnv1a"])
def test_seq_cov_byte_identical_to_jax(metagenomes, k, extra, tmp_path,
                                       monkeypatch):
    """Sequences shorter than k - 1 write -0.0, as the JAX package does."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    bins, seqs = _seq_cov_inputs(metagenomes, tmp_path)
    for main, tag in ((jax_main, "j"), (port_main, "t")):
        assert main(_seq_cov_args(bins, seqs, k, tmp_path / f"o{tag}",
                                  tmp_path / f"w{tag}", *extra)) == 0
    got, want = _tree(tmp_path / "ot"), _tree(tmp_path / "oj")
    assert list(got) == ["seq_cov.csv"] and got == want
    lines = got["seq_cov.csv"].decode().splitlines()
    assert len(lines) == 1 + 4 + 16
    assert float(lines[1].split(", ")[2]) > 0.9   # a graph read, in donor
    assert lines[-1].endswith(", -0.0")            # 15 bases < k - 1


@pytest.mark.parametrize("k", [21, 33])
def test_seq_cov_k_minus_one_fails_like_jax(metagenomes, k, tmp_path,
                                            monkeypatch):
    """A sequence of k - 1 bases: printSeqBin divides by len - k + 1 = 0.
    The Java reference prints NaN; the JAX package raises
    ZeroDivisionError, and so does the port."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    bins, _ = _seq_cov_inputs(metagenomes, tmp_path)
    seqs = tmp_path / "short.fasta"
    seqs.write_text(f">ok\n{'ACGT' * 10}\n>short\n{'ACGT' * 10}"[:-(41 - k)]
                    + "\n")
    assert len(seqs.read_text().splitlines()[-1]) == k - 1
    for main, tag in ((jax_main, "j"), (port_main, "t")):
        with pytest.raises(ZeroDivisionError):
            main(_seq_cov_args(bins, str(seqs), k, tmp_path / f"o{tag}",
                               tmp_path / f"w{tag}"))
    assert (tmp_path / "ot" / "seq_cov.csv").read_bytes() == \
        (tmp_path / "oj" / "seq_cov.csv").read_bytes()
