"""KmerMap.get_many's two lookups: a search of the sorted keys, and the
probe table of the whole map, which only bulk callers build.

Both give the same counts on hits, misses, an empty map, saturated counts
and hashed (signed, full-range) keys. get_many alone never builds the
table, however many queries it answers; the table is built once, with 8
threads asking at once. The reads classifiers and
load_present_kmer_strings build it before their first lookup.
"""
import sys
import threading

import numpy as np
import pytest

from metacherchant_tpu_torch import trace
from metacherchant_tpu_torch.kmer_map import SATURATION, KmerMap

N_KEYS = 90_000


def _case(name: str, seed: int = 5):
    """(keys, counts, queries) of each case."""
    rng = np.random.default_rng(seed)
    if name == "empty":
        return (np.empty(0, np.int64), np.empty(0, np.int32),
                rng.integers(0, 1 << 40, 1000))
    if name == "hashed":  # signed 64-bit hashes, both signs, the extremes
        keys = np.unique(np.concatenate([
            rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                         N_KEYS, dtype=np.int64),
            np.array([np.iinfo(np.int64).min, -1, 0,
                      np.iinfo(np.int64).max], np.int64)]))
    else:  # 2-bit packed 31-mers
        keys = np.unique(rng.integers(0, 1 << 62, N_KEYS, dtype=np.int64))
    counts = rng.integers(1, 200, keys.size)
    if name == "saturated":
        counts[::3] = rng.integers(SATURATION - 5, 3 * SATURATION,
                                   counts[::3].size)
    hits = rng.choice(keys, 12_000)
    misses = rng.integers(keys.min(), keys.max(), 12_000, dtype=np.int64)
    misses = misses[~np.isin(misses, keys)]
    query = {"hits": hits, "misses": misses, "saturated": hits,
             "hashed": np.concatenate([hits, misses, keys[:2], keys[-2:]])
             }[name]
    return keys, counts, rng.permutation(query)


def _oracle(keys, counts, query) -> np.ndarray:
    d = dict(zip(keys.tolist(), np.minimum(counts, SATURATION).tolist()))
    return np.array([d.get(q, -1) for q in query.tolist()], np.int32)


CASES = ["hits", "misses", "empty", "saturated", "hashed"]


@pytest.mark.parametrize("case", CASES)
def test_search_and_probe_table_give_the_same_counts(case):
    keys, counts, query = _case(case)
    searched, probed = KmerMap(keys, counts), KmerMap(keys, counts)
    probed._probe_table()
    with trace.recording() as rec:
        got = searched.get_many(query.reshape(-1, 4) if query.size % 4 == 0
                                else query)
        want = probed.get_many(query)
    assert not hasattr(searched, "_ptable")
    assert np.array_equal(got.ravel(), want)
    assert np.array_equal(want, _oracle(keys, counts, query))
    assert want.dtype == np.int32
    if case == "saturated":
        assert (want == SATURATION).sum() > 1000
    if case in ("misses", "empty"):
        assert (want == -1).all()
    assert "tables.probe" not in rec.counters


@pytest.mark.parametrize("case", CASES)
def test_get_many_alone_never_builds_a_table(case):
    """Three times as many queries as the map has keys, in calls of ~24k,
    all answered by search."""
    keys, counts, query = _case(case)
    kmap = KmerMap(keys, counts)
    want = _oracle(keys, counts, query)
    with trace.recording() as rec:
        asked = 0
        while asked < 3 * max(keys.size, 1):
            assert np.array_equal(kmap.get_many(query), want)
            asked += query.size
    assert not hasattr(kmap, "_ptable")
    assert "tables.probe" not in rec.counters
    assert "kmap.probe_table" not in [s.name for s in rec.spans]


@pytest.mark.parametrize("case", ["hits", "saturated", "hashed"])
def test_one_table_build_under_eight_threads(case):
    """8 threads search, build the table and probe it, all at once: one
    build, and every answer right before, during and after it."""
    keys, counts, query = _case(case)
    kmap = KmerMap(keys, counts)
    want = _oracle(keys, counts, query)
    start = threading.Barrier(8)
    bad = []

    def ask():
        start.wait()
        for _ in range(2):
            if not np.array_equal(kmap.get_many(query), want):
                bad.append(threading.get_ident())
        kmap._probe_table()
        for _ in range(2):
            if not np.array_equal(kmap.get_many(query), want):
                bad.append(threading.get_ident())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: races show
    try:
        with trace.recording() as rec:
            threads = [threading.Thread(target=ask) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert rec.counters["tables.probe"] == 1
    assert [s.name for s in rec.spans].count("kmap.probe_table") == 1
    with trace.recording() as again:
        assert np.array_equal(kmap.get_many(query), want)
        kmap._probe_table()
    assert again.counters == {}


@pytest.mark.parametrize("threads", ["1", "2"])
def test_classifier_builds_its_table_before_the_first_batch(
        tmp_path, threads, monkeypatch):
    """A map of 30k keys and 4k lookups a mate: the classifier has the
    table before its first batch."""
    from metacherchant_tpu_torch.counting import count_sequences_host
    from metacherchant_tpu_torch.tools import reads_classifier as RC
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_CLASSIFY_THREADS", threads)
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", "")
    rng = np.random.default_rng(23)
    genome = "".join(rng.choice(list("ACGT"), 30_000))
    kmap = count_sequences_host([genome], 21)
    for mate in (1, 2):
        starts = rng.integers(0, len(genome) - 100, 50)
        (tmp_path / f"r{mate}.fastq").write_text("".join(
            f"@p{i}/{mate}\n{genome[s:s + 100]}\n+\n{'I' * 100}\n"
            for i, s in enumerate(starts)))
    seen = []
    real = RC.find_reads

    def spy(*args):
        seen.append(hasattr(kmap, "_ptable"))
        return real(*args)

    monkeypatch.setattr(RC, "find_reads", spy)
    files = [str(tmp_path / "r1.fastq"), str(tmp_path / "r2.fastq")]
    with trace.recording() as rec:
        found = [f1.sum() + f2.sum() for _, _, f1, f2 in RC._classified_stream(
            files, kmap, 21, None, 1.0, 0.9, False)]
    assert seen == [True, True] and sum(found) == 100
    assert rec.counters["tables.probe"] == 1


def _reads(tmp_path, rng, genome: str, names: list[str]) -> list[str]:
    files = []
    for mate, name in enumerate(names, 1):
        starts = rng.integers(0, len(genome) - 100, 60)
        files.append(str(tmp_path / name))
        (tmp_path / name).write_text("".join(
            f"@p{i}/{mate}\n{genome[s:s + 100]}\n+\n{'I' * 100}\n"
            for i, s in enumerate(starts)))
    return files


@pytest.mark.parametrize("caller", ["triple-reads-classifier",
                                    "load_present_kmer_strings"])
def test_bulk_callers_build_their_table_before_the_first_lookup(
        tmp_path, caller, monkeypatch):
    """The triple classifier builds one table for each of its two maps
    (k and k2) before the pass over the reads that probes it;
    load_present_kmer_strings builds one before its first block."""
    from metacherchant_tpu_torch.counting import (
        count_sequences_host, load_present_kmer_strings)
    from metacherchant_tpu_torch.runner import main as port_main
    from metacherchant_tpu_torch.tools import triple_reads_classifier as TRC
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", "")
    rng = np.random.default_rng(31)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    seen = []
    if caller == "triple-reads-classifier":
        graph, r1, r2 = _reads(tmp_path, rng, genome,
                               ["g.fastq", "r1.fastq", "r2.fastq"])
        real = TRC.find_reads

        def spy(batch, kmap, *args):
            seen.append((id(kmap), hasattr(kmap, "_ptable")))
            return real(batch, kmap, *args)

        monkeypatch.setattr(TRC, "find_reads", spy)
        with trace.recording() as rec:
            assert port_main([
                "-t", "triple-reads-classifier", "-k", "21", "-k2", "33",
                "-i", graph, "-r", r1, r2, "-o", str(tmp_path / "out"),
                "--work-dir", str(tmp_path / "wd")]) == 0
        assert len({m for m, _ in seen}) == 2
        assert rec.counters["tables.probe"] == 2
    else:
        (reads,) = _reads(tmp_path, rng, genome, ["r.fastq"])
        kmap = count_sequences_host([genome[:2000]], 33, "poly")
        real = kmap.get_many

        def spy(query):
            seen.append((id(kmap), hasattr(kmap, "_ptable")))
            return real(query)

        monkeypatch.setattr(kmap, "get_many", spy)
        with trace.recording() as rec:
            got = load_present_kmer_strings([reads], 33, "poly", kmap,
                                            rows_per_batch=1000)
        assert len(got) > 100 and len(seen) > 1
        assert rec.counters["tables.probe"] == 1
    assert seen and all(built for _, built in seen)
