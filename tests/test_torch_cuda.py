"""Tests of the port that need a CUDA GPU: the extraction kernel against its
plain torch version on the card, the hashed keys, the map lookup, the device
contraction, the hash table, the device BFS engines, the consolidation
modes and the bitonic/merge-split units on the card against the CPU, the
merge and chunk counting engines against the sort engine, the multiword
visited set's slot election under contention, the device classify coverage
against the host one (reads-classifier's and triple-reads-classifier's),
the sharded engine and BFS in an NCCL group of world size 1 against the
sort engine and bfs_layered, and the main path on the card against the
host oracle and against the same run on the CPU.

They skip where torch sees no CUDA device. This file imports no JAX, so it
also runs on a machine without it (tests/conftest.py imports JAX, hence
--noconftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from metacherchant_tpu_torch import trace
from metacherchant_tpu_torch.algo import classify
from metacherchant_tpu_torch.counting import (count_kmers_device,
                                              count_kmers_host)
from metacherchant_tpu_torch.io.readers import DnaQ
from metacherchant_tpu_torch.kmer_map import KmerMap
from metacherchant_tpu_torch.dna import normalize
from metacherchant_tpu_torch.ops import extract_cuda
from metacherchant_tpu_torch.ops.contraction_device import (
    contract_codes_device)
from metacherchant_tpu_torch.ops.kmers import (SENTINEL,
                                               fw_codes_of_kmer_strings,
                                               hash_canonical_kmers)
from metacherchant_tpu_torch.ops.sortcount import append_codes, append_ragged
from metacherchant_tpu_torch.runner import main as port_main

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(seed: int, rows: int, length: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (rows, length)).astype(np.int8)
    codes[rng.random((rows, length)) < 0.03] = -1
    tail = rng.integers(0, length + 1, rows)
    codes[np.arange(length)[None, :] >= tail[:, None]] = -1
    return codes


def _write_fastq(path, seed: int, n: int = 3000) -> None:
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 20_000))
    with open(path, "w") as f:
        for i in range(n):
            ln = 300 if i % 97 == 0 else 150
            s = int(rng.integers(0, len(genome) - ln))
            r = genome[s:s + ln]
            if i % 11 == 0:
                p = int(rng.integers(0, ln - 2))
                r = r[:p] + "NN" + r[p + 2:]
            f.write(f"@r{i}\n{r}\n+\n{'I' * ln}\n")


@pytest.mark.parametrize("k", [1, 3, 15, 16, 17, 21, 31])
def test_kernel_matches_plain_on_card(cuda, k):
    """777 rows: not a multiple of the 128-thread block."""
    codes = _codes(k, 777, 300)
    n = 777 * (300 - k + 1)
    got = torch.empty(n, dtype=torch.int64, device=cuda)
    want = torch.empty_like(got)
    before = trace.counter("extract.launches")
    extract_cuda.extract_append(torch.from_numpy(codes).to(cuda), k, got)
    assert trace.counter("extract.launches") == before + 1
    extract_cuda.extract_append_plain(torch.from_numpy(codes).to(cuda), k,
                                      want)
    on_cpu = torch.empty(n, dtype=torch.int64)
    extract_cuda.extract_append(torch.from_numpy(codes), k, on_cpu)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), on_cpu)


def test_append_writes_only_its_lanes(cuda):
    k = 21
    codes = torch.from_numpy(_codes(5, 300, 100)).to(cuda)
    buf = torch.full((300 * 80 + 100,), 7, dtype=torch.int64, device=cuda)
    off = append_codes(buf, 40, codes, k)
    torch.cuda.synchronize()
    host = buf.cpu()
    assert off == 40 + 300 * 80
    assert torch.all(host[:40] == 7) and torch.all(host[off:] == 7)
    assert torch.any(host[40:off] == SENTINEL)


def test_count_on_card_matches_host(cuda, tmp_path):
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, 1)
    for k in (21, 31):
        got = count_kmers_device([path], k, batch=256, max_len=128,
                                 table_log2=12, device=cuda)
        want = count_kmers_host([path], k)
        assert np.array_equal(got.keys, want.keys)
        assert np.array_equal(got.counts, want.counts)


def test_cli_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    reads = str(tmp_path / "reads.fastq")
    _write_fastq(reads, 2)
    genes = tmp_path / "genes.fasta"
    with open(reads) as fh:
        fh.readline()
        seq = fh.readline().strip()
    genes.write_text(f">g1\n{seq.replace('N', 'A')}\n")
    trees = {}
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("MC_PLATFORM", platform)
        out = tmp_path / f"out_{platform}"
        assert port_main(["-t", "environment-finder", "-k", "31",
                          "-i", reads, "--seq", str(genes), "-o", str(out),
                          "--coverage", "2", "--maxradius", "300",
                          "--work-dir", str(tmp_path / f"wd_{platform}")]) == 0
        trees[platform] = {
            os.path.relpath(os.path.join(d, n), out): Path(d, n).read_bytes()
            for d, _, names in os.walk(out) for n in names}
    assert trees["cuda"] and trees["cuda"] == trees["cpu"]


def _ragged_rows(seed: int, rows: int, k: int, layout: str):
    """(codes, starts, lens) in numpy: 'chunked' rows follow each other as
    counting's chunks do (gaps, k-1 overlaps, lengths in [k, 256]); 'spread'
    rows lie far apart, so a tile of them spans more than the kernel stages;
    'long' rows of 2,000-3,000 codes, the same."""
    rng = np.random.default_rng(seed)
    if layout == "long":
        lens = rng.integers(2000, 3001, rows)
    else:
        lens = rng.integers(k, 257, rows)
    if layout == "spread":
        starts = rng.integers(0, 4_000_000, rows)
    else:
        step = lens[:-1] - np.where(rng.random(rows - 1) < 0.3, k - 1, 0)
        step += rng.integers(0, 3, rows - 1) * (rng.random(rows - 1) < 0.2)
        starts = int(rng.integers(0, 16)) + np.concatenate(
            [[0], np.cumsum(step)])
    codes = rng.integers(0, 4, int((starts + lens).max()) + 40).astype(np.int8)
    codes[rng.random(codes.size) < 0.01] = -1
    return codes, starts.astype(np.int64), lens.astype(np.int32)


def _ragged_on(dev, codes, starts, lens, k):
    offs = extract_cuda.row_offsets(lens, k)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(starts).to(dev),
            torch.from_numpy(lens).to(dev), torch.from_numpy(offs).to(dev),
            int((lens.astype(np.int64) - k + 1).sum()))


@pytest.mark.parametrize("k", [1, 3, 15, 16, 17, 21, 31])
def test_ragged_kernel_matches_plain_on_card(cuda, k):
    """777 chunked rows (tiles of 16 rows straddle them unevenly), with the
    code array starting at every residue mod 16 bytes; rows far apart and
    long rows, which the kernel reads from device memory."""
    for layout, rows in (("chunked", 777), ("spread", 300), ("long", 40)):
        codes, starts, lens = _ragged_rows(k, rows, k, layout)
        for shift in range(16) if layout == "chunked" else (0, 5):
            whole = np.concatenate([np.zeros(shift, np.int8), codes])
            d = torch.from_numpy(whole).to(cuda)[shift:]
            assert d.data_ptr() % 16 == shift
            _, ds, dl, do, n = _ragged_on(cuda, codes, starts, lens, k)
            got = torch.full((n,), 7, dtype=torch.int64, device=cuda)
            want = torch.empty_like(got)
            before = trace.counter("extract.launches")
            extract_cuda.extract_append_ragged(d, ds, dl, do, k, got)
            assert trace.counter("extract.launches") == before + 1
            extract_cuda.extract_append_ragged_plain(d, ds, dl, do, k, want)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (layout, shift)
        on_cpu = torch.empty(n, dtype=torch.int64)
        extract_cuda.extract_append_ragged(
            torch.from_numpy(codes), torch.from_numpy(starts),
            torch.from_numpy(lens),
            torch.from_numpy(extract_cuda.row_offsets(lens, k)), k, on_cpu)
        assert torch.equal(got.cpu(), on_cpu)


@pytest.mark.parametrize("case", ["short_row", "negative_start",
                                  "past_end", "offs_not_running_sum",
                                  "out_too_large"])
def test_ragged_kernel_rejects_bad_tables(cuda, case):
    """The kernel checks the tables and the wrapper raises; a tile with a
    fault writes nothing."""
    k = 21
    codes, starts, lens = _ragged_rows(3, 100, k, "chunked")
    if case == "short_row":
        lens[50] = k - 1  # no window; the offsets stay a running sum
    elif case == "negative_start":
        starts[0] = -1
    elif case == "past_end":
        starts[99] = codes.size - lens[99] + 1
    dc, ds, dl, do, n = _ragged_on(cuda, codes, starts, lens, k)
    n += case == "out_too_large"
    if case == "offs_not_running_sum":
        do[60] += 1
    out = torch.full((n,), 7, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="bad ragged rows"):
        extract_cuda.extract_append_ragged(dc, ds, dl, do, k, out)
    if case == "short_row":  # the tile of row 50 wrote nothing
        offs = extract_cuda.row_offsets(lens, k)
        tile = slice(int(offs[48]), int(offs[64]))
        assert torch.all(out[tile].cpu() == 7)


def test_ragged_append_writes_only_its_lanes(cuda):
    k = 21
    codes, starts, lens = _ragged_rows(8, 300, k, "chunked")
    dc, ds, dl, do, n = _ragged_on(cuda, codes, starts, lens, k)
    buf = torch.full((n + 140,), 7, dtype=torch.int64, device=cuda)
    off = append_ragged(buf, 40, dc, ds, dl, do, n, k)
    torch.cuda.synchronize()
    host = buf.cpu()
    assert off == 40 + n
    assert torch.all(host[:40] == 7) and torch.all(host[off:] == 7)
    assert torch.any(host[40:off] == SENTINEL)
    assert not torch.any(host[40:off] == 7)


def test_launch_count_is_exact_across_threads(cuda):
    """Both entries, 50 launches each from each of 8 threads."""
    codes = torch.from_numpy(_codes(9, 64, 100)).to(cuda)
    outs = [torch.empty(64 * 80, dtype=torch.int64, device=cuda)
            for _ in range(8)]
    rc, rs, rl = _ragged_rows(9, 64, 21, "chunked")
    ragged = _ragged_on(cuda, rc, rs, rl, 21)
    routs = [torch.empty(ragged[-1], dtype=torch.int64, device=cuda)
             for _ in range(8)]
    before = trace.counter("extract.launches")

    def work(out, rout):
        for _ in range(50):
            extract_cuda.extract_append(codes, 21, out)
            extract_cuda.extract_append_ragged(*ragged[:4], 21, rout)

    threads = [threading.Thread(target=work, args=pair)
               for pair in zip(outs, routs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert trace.counter("extract.launches") == before + 800


@pytest.mark.parametrize("engine", ["sort", "merge", "chunk"])
def test_launch_counter_equals_launch_spans_on_card(cuda, engine, tmp_path):
    """Each count.launch span of exact counting on the card launches the
    kernel once, so the counter extract.launches equals the spans, and the
    spans' windows are every k-mer the map counts."""
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, 23)
    with trace.recording() as rec:
        kmap = count_kmers_device([path], 31, device=cuda, engine=engine,
                                  batch=256, max_len=128, table_log2=10)
    launches = [s for s in rec.spans if s.name == "count.launch"]
    assert rec.counters["extract.launches"] == len(launches) > 0
    assert sum(s.attrs["windows"] for s in launches) == int(
        kmap.counts.astype(np.int64).sum())


@pytest.mark.parametrize("k", [32, 55, 63])
@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
def test_hashed_keys_on_card_match_cpu(cuda, k, hasher):
    """Rows of 256 codes, where the poly sums and FNV products wrap."""
    codes = torch.from_numpy(_codes(k, 777, 256))
    got, got_ok = hash_canonical_kmers(codes.to(cuda), k, hasher)
    want, want_ok = hash_canonical_kmers(codes, k, hasher)
    assert torch.equal(got_ok.cpu(), want_ok)
    assert torch.equal(got.cpu(), want)
    assert bool((want[want_ok] < 0).any())


def test_lookup_device_on_card_matches_get_many(cuda):
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(np.iinfo(np.int64).min,
                                  np.iinfo(np.int64).max, 200_000,
                                  dtype=np.int64))
    kmap = KmerMap(keys, rng.integers(1, 40000, keys.size))
    q = np.concatenate([keys[::3], rng.integers(
        np.iinfo(np.int64).min, np.iinfo(np.int64).max, 50_000,
        dtype=np.int64), [np.iinfo(np.int64).min, np.iinfo(np.int64).max]])
    got = kmap.lookup_device(torch.from_numpy(q).to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert np.array_equal(got.cpu().numpy(), kmap.get_many(q))
    empty = KmerMap(np.empty(0, np.int64), np.empty(0, np.int32))
    assert torch.all(empty.lookup_device(torch.from_numpy(q).to(cuda)) == -1)


@pytest.mark.parametrize("k,hasher", [(21, None), (31, None), (33, "poly"),
                                      (55, "fnv1a")])
def test_device_coverage_on_card_matches_host(cuda, k, hasher, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cuda")
    rng = np.random.default_rng(k)
    genome = "".join(rng.choice(list("ACGT"), 5000))
    reads = [genome[s:s + int(n)] for s, n in
             zip(rng.integers(0, 4800, 500), rng.integers(10, 150, 500))]
    reads += ["".join(rng.choice(list("ACGTN"), 120)) for _ in range(100)]
    monkeypatch.delenv("MC_DEVICE_CLASSIFY", raising=False)
    fasta = tmp_path / "genome.fasta"
    fasta.write_text(f">g1\n{genome}\n>g2\n{genome}\n")
    counted = count_kmers_host([str(fasta)], k, hasher)
    batch = classify.ReadBatch.from_dnaqs(
        [DnaQ.from_string(r, 30) for r in reads])
    before = trace.counter("extract.launches")
    got_cov = classify._window_counts_device(batch, counted, k, hasher)
    assert trace.counter("extract.launches") == before + (hasher is None)
    assert got_cov.device.type == "cuda"
    want_cov = classify._window_counts_host(batch, counted, k, hasher)
    valid = (np.arange(want_cov.shape[1])[None, :]
             < (batch.lengths - k + 1)[:, None])
    assert tuple(got_cov.shape) == want_cov.shape
    assert np.array_equal(got_cov.cpu().numpy()[valid], want_cov[valid])
    assert (want_cov[valid] > 0).any()
    want = classify._coverage(batch, counted, k, hasher)
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", "1")
    got = classify._coverage(batch, counted, k, hasher)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("k", [21, 31])
def test_contract_codes_on_card_matches_cpu(cuda, k):
    """A 20 kbp genome's k-mers in three color blocks, a cycle, a
    self-loop."""
    rng = np.random.default_rng(k)
    genome = "".join(rng.choice(list("ACGT"), 20_000))
    circ = "".join(rng.choice(list("ACGT"), 300))
    tag_of = {}
    for tag, seq in enumerate((genome[:8000], genome[8000 - k + 1:],
                               circ + circ[:k - 1], "A" * 40)):
        for i in range(len(seq) - k + 1):
            tag_of.setdefault(normalize(seq[i:i + k]), tag % 3)
    kmers = sorted(tag_of)
    codes = torch.from_numpy(fw_codes_of_kmer_strings(kmers, k))
    tags = torch.tensor([tag_of[s] for s in kmers], dtype=torch.int32)
    got = contract_codes_device(codes.to(cuda), tags.to(cuda), k)
    want = contract_codes_device(codes, tags, k)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    assert int(want[3].max()) > 100


def test_triple_classifier_device_coverage_on_card_matches_host(
        cuda, tmp_path, monkeypatch):
    graph = str(tmp_path / "graph.fastq")
    _write_fastq(graph, 4)
    r1, r2 = str(tmp_path / "r1.fastq"), str(tmp_path / "r2.fastq")
    _write_fastq(r1, 4, 900)
    _write_fastq(r2, 5, 700)
    monkeypatch.setenv("MC_PLATFORM", "cuda")
    trees, launches = {}, {}
    for mode in ("", "1"):
        monkeypatch.setenv("MC_DEVICE_CLASSIFY", mode)
        out = tmp_path / f"out{mode}"
        before = trace.counter("extract.launches")
        assert port_main(["-t", "triple-reads-classifier", "-k", "21",
                          "-k2", "33", "-i", graph, "-r", r1, r2,
                          "-o", str(out),
                          "--work-dir", str(tmp_path / f"wd{mode}")]) == 0
        launches[mode] = trace.counter("extract.launches") - before
        trees[mode] = {n: (out / n).read_bytes() for n in os.listdir(out)}
    assert len(trees[""]) == 9 and trees["1"] == trees[""]
    # r1 comes from the graph's genome, r2 from another one
    assert trees[""]["found_s.fastq"] and trees[""]["not_found_s.fastq"]
    # counting at 21 (one batch each run); the device run adds four per
    # batch pair of pass 1 (find_reads and batch_widths of both mates), and
    # none at 33
    assert launches[""] == 1 and launches["1"] == 1 + 4


def test_device_contract_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    reads = str(tmp_path / "reads.fastq")
    _write_fastq(reads, 6)
    genes = tmp_path / "genes.fasta"
    with open(reads) as fh:
        fh.readline()
        seq = fh.readline().strip()
    genes.write_text(f">g1\n{seq.replace('N', 'A')}\n")
    monkeypatch.setenv("MC_DEVICE_CONTRACT", "1")
    trees = {}
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("MC_PLATFORM", platform)
        out = tmp_path / f"out_{platform}"
        assert port_main(["-t", "environment-finder", "-k", "31",
                          "-i", reads, "--seq", str(genes), "-o", str(out),
                          "--coverage", "2", "--maxradius", "300",
                          "--work-dir", str(tmp_path / f"wd_{platform}")]) == 0
        trees[platform] = {
            os.path.relpath(os.path.join(d, n), out): Path(d, n).read_bytes()
            for d, _, names in os.walk(out) for n in names}
    assert trees["cuda"] and trees["cuda"] == trees["cpu"]


def test_hash_table_on_card_matches_cpu(cuda):
    """Duplicates, keys with bit 63 set, saturation and growth from 2^6
    slots: the card's contents and lookups equal the CPU's."""
    from metacherchant_tpu_torch.ops.hashtable import DeviceHashTable
    rng = np.random.default_rng(7)
    pool = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        50_000, dtype=np.int64)
    batches = [rng.choice(pool, 200_000) for _ in range(4)]
    batches.append(np.full(40_000, 42, np.int64))
    tables = {}
    for dev in (cuda, torch.device("cpu")):
        t = DeviceHashTable(dev, capacity_log2=6)
        for b in batches:
            t.insert_batch(torch.from_numpy(b).to(dev))
        tables[dev.type] = t
    got, want = tables["cuda"].items_host(), tables["cpu"].items_host()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert tables["cuda"].size == want[0].size and want[1].max() == 32767
    q = np.concatenate([pool[::3], rng.integers(0, 1 << 62, 10_000),
                        [SENTINEL]])
    assert np.array_equal(
        tables["cuda"].lookup(torch.from_numpy(q).to(cuda)).cpu().numpy(),
        tables["cpu"].lookup(torch.from_numpy(q)).numpy())


@pytest.mark.parametrize("k,hasher", [(31, None), (55, "poly")])
def test_hash_engine_on_card_matches_sort(cuda, k, hasher, tmp_path,
                                         monkeypatch):
    """MC_COUNT_ENGINE=hash on the card: the sort engine's map; exact keys
    go through the kernel's ragged entry as often as the sort engine's."""
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, 9)
    geom = dict(batch=256, max_len=128, table_log2=10)
    launches = []
    for engine in ("sort", "hash"):
        monkeypatch.setenv("MC_COUNT_ENGINE", engine)
        before = trace.counter("extract.launches")
        got = count_kmers_device([path], k, hasher, device=cuda, **geom)
        launches.append(trace.counter("extract.launches") - before)
        if engine == "sort":
            want = got
    assert launches[0] == launches[1]
    assert (launches[1] > 0) == (hasher is None)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)


@pytest.mark.parametrize("k,hasher", [(31, None), (55, "poly")])
def test_merge_and_chunk_engines_on_card_match_sort(cuda, k, hasher,
                                                    tmp_path):
    """MC_COUNT_ENGINE=merge and chunk on the card: the sort engine's map.
    Exact keys go through the kernel's ragged entry once per run (merge,
    as often as sort) and once per buffer fill (chunk, fewer)."""
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, 11)
    geom = dict(batch=256, max_len=128, table_log2=10)
    maps, launches = {}, {}
    for engine in ("sort", "merge", "chunk"):
        before = trace.counter("extract.launches")
        maps[engine] = count_kmers_device([path], k, hasher, device=cuda,
                                          engine=engine, **geom)
        launches[engine] = trace.counter("extract.launches") - before
    assert launches["merge"] == launches["sort"]
    assert (launches["sort"] > 0) == (hasher is None)
    assert launches["chunk"] < launches["sort"] or hasher is not None
    for engine in ("merge", "chunk"):
        assert np.array_equal(maps[engine].keys, maps["sort"].keys)
        assert np.array_equal(maps[engine].counts, maps["sort"].counts)


@pytest.mark.parametrize("compaction", ["sort2", "shift"])
@pytest.mark.parametrize("mode", ["auto", "sort2", "merge"])
def test_stream_counter_modes_on_card_match_cpu(cuda, mode, compaction,
                                                monkeypatch):
    """StreamCounter in each consolidation mode on the card: the CPU's
    store after every batch (store growth included)."""
    monkeypatch.setenv("MC_SORT_COMPACTION", compaction)
    from metacherchant_tpu_torch.ops.sortcount import StreamCounter
    caps = dict(buffer_cap=3 << 14, store_cap=1 << 14, mode=mode)
    counters = {d: StreamCounter(d, **caps)
                for d in (cuda, torch.device("cpu"))}
    for seed in range(48):  # batches of 8,320 keys, below every buffer size
        codes = torch.from_numpy(_codes(seed, 64, 150))
        for d, sc in counters.items():
            sc.add_codes(codes.to(d), 21)
        gpu, cpu = counters.values()
        assert torch.equal(gpu.store_keys.cpu(), cpu.store_keys)
        assert torch.equal(gpu.store_cnts.cpu(), cpu.store_cnts)
    got, want = (sc.finalize() for sc in counters.values())
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert gpu.store_cap > caps["store_cap"]


def test_bitonic_and_merge_split_on_card_match_cpu(cuda):
    """The bitonic primitives and both full-length consolidations on the
    card: the CPU's lanes, bit for bit, at 2^18 and 3·2^17 lanes."""
    from metacherchant_tpu_torch.ops import bitonic, sortcount
    rng = np.random.default_rng(12)
    store_n, buf_n = 1 << 17, 1 << 18
    keys = np.unique(rng.integers(0, 1 << 40, store_n))[:store_n - 100]
    store = np.full(store_n, SENTINEL, np.int64)
    store[:keys.size] = keys
    cnts = np.where(store == SENTINEL, 0,
                    rng.integers(1, 50, store_n)).astype(np.int32)
    buf = np.concatenate([rng.choice(keys, buf_n // 2),
                          rng.integers(0, 1 << 40, buf_n // 2)])
    run = np.sort(buf[:buf_n // 2])
    cases = {
        "bitonic_merge": (bitonic.bitonic_merge, (store, run, cnts,
                                                  np.ones_like(cnts))),
        "merge_rle_compact": (bitonic.merge_rle_compact, (store, cnts, run)),
        "merge_split": (sortcount._consolidate_merge_split,
                        (store, cnts, buf, buf_n - 5)),
        "full_split": (sortcount._consolidate_full_split,
                       (store[:buf_n // 2], cnts[:buf_n // 2], buf, 7)),
    }
    for name, (fn, args) in cases.items():
        outs = {}
        for d in (cuda, torch.device("cpu")):
            dev_args = [torch.from_numpy(a).to(d) if isinstance(a, np.ndarray)
                        else a for a in args]
            outs[d.type] = [t.cpu() for t in fn(*dev_args)]
        for g, c in zip(outs["cuda"], outs["cpu"], strict=True):
            assert torch.equal(g, c), name


@pytest.fixture
def nccl(cuda):
    """The sharded engine's process group of world size 1 on the card
    (nccl), destroyed afterwards."""
    import torch.distributed as dist
    from metacherchant_tpu_torch.parallel.distributed import (
        initialize_distributed)
    initialize_distributed(device=cuda)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    yield cuda
    dist.destroy_process_group()


@pytest.mark.parametrize("k,hasher", [(31, None), (55, "poly")])
def test_sharded_engine_on_card_matches_sort(nccl, k, hasher, tmp_path):
    """MC_COUNT_ENGINE=sharded at world size 1 on the card: the sort
    engine's map; exact keys through the kernel's ragged entry as often as
    the sort engine's (batch // 1 chunks a launch)."""
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, 10)
    geom = dict(batch=256, max_len=128, table_log2=10)
    maps, launches = {}, {}
    for engine in ("sort", "sharded"):
        before = trace.counter("extract.launches")
        maps[engine] = count_kmers_device([path], k, hasher, device=nccl,
                                          engine=engine, **geom)
        launches[engine] = trace.counter("extract.launches") - before
    assert launches["sharded"] == launches["sort"]
    assert (launches["sort"] > 0) == (hasher is None)
    assert np.array_equal(maps["sharded"].keys, maps["sort"].keys)
    assert np.array_equal(maps["sharded"].counts, maps["sort"].counts)


@pytest.mark.parametrize("direction", [-1, 1, 0])
def test_sharded_bfs_on_card_matches_host(nccl, direction):
    """run_sharded_bfs at world size 1 on the card: bfs_layered's set."""
    from metacherchant_tpu_torch.algo.environment import bfs_layered
    from metacherchant_tpu_torch.parallel.sharded_bfs import run_sharded_bfs
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), 20_000))
    kmap = KmerMap.from_dict(count_kmers_host_of(genome, 21))
    seeds = np.unique(rng.choice(kmap.keys, 500, replace=False))
    want = bfs_layered(seeds, kmap, 21, 1, direction, 30).visited
    got = run_sharded_bfs(seeds, kmap, 21, 1, direction, 30, device=nccl)
    assert want.size > seeds.size and np.array_equal(got, want)


def count_kmers_host_of(seq: str, k: int) -> dict[int, int]:
    from metacherchant_tpu_torch.counting import _count_codes_into
    from metacherchant_tpu_torch.dna import encode
    counts: dict[int, int] = {}
    _count_codes_into(counts, encode(seq), k, None)
    return counts


def test_multiword_set_election_many_rows_on_few_slots(cuda):
    """Rows of three words, 30,000 of them into 2^15 slots at once, then
    duplicates and more rows: every used slot holds a row that was
    inserted (no torn row made of two claimants' words) and each row lands
    exactly once."""
    from metacherchant_tpu_torch.ops import bfs_hashed as TM
    rng = np.random.default_rng(11)
    rows = np.unique(rng.integers(np.iinfo(np.int64).min,
                                  np.iinfo(np.int64).max, (31_000, 3),
                                  dtype=np.int64), axis=0)[:30_000]
    # rows sharing two of three words make a torn row a real row's twin
    rows[1::2, :2] = rows[0::2, :2]
    rows = np.unique(rows, axis=0)
    skeys = torch.zeros((1 << 15, 3), dtype=torch.int64, device=cuda)
    owner = torch.full((1 << 15,), -1, dtype=torch.int32, device=cuda)
    d = torch.from_numpy(rows).to(cuda)
    half = rows.shape[0] // 2
    new, won = TM._mwset_insert(skeys, owner, d[:half])
    assert new == half and bool(won.all())
    new, won = TM._mwset_insert(skeys, owner, d)
    assert new == rows.shape[0] - half
    assert np.array_equal(won.cpu().numpy(), np.arange(rows.shape[0]) >= half)
    held = skeys[owner >= 0].cpu().numpy()
    assert held.shape[0] == rows.shape[0]
    assert np.array_equal(np.unique(held, axis=0), rows)


@pytest.mark.parametrize("engine", ["dense", "probe", "multiword"])
def test_device_bfs_on_card_matches_cpu(cuda, engine):
    """Each engine on the card against the same engine on the CPU, for
    every direction, bounded and unbounded."""
    from metacherchant_tpu_torch.ops import bfs_dense, bfs_device, bfs_hashed
    from metacherchant_tpu_torch.algo.environment import (
        seed_codes_of_sequences)
    rng = np.random.default_rng(12)
    genome = "".join(rng.choice(list("ACGT"), 20_000))
    fasta_reads = [genome[s:s + 150] for s in rng.integers(0, 19_850, 2000)]
    k = 33 if engine == "multiword" else 21
    hasher = "fnv1a" if engine == "multiword" else None
    from metacherchant_tpu_torch.counting import _count_codes_into
    from metacherchant_tpu_torch.dna import encode
    counts: dict[int, int] = {}
    for r in fasta_reads:
        _count_codes_into(counts, encode(r), k, hasher)
    kmap = KmerMap.from_dict(counts)
    gene = genome[5000:5600]
    for direction in (-1, 0, 1):
        for mr in (None, 40):
            outs = []
            for dev in (cuda, torch.device("cpu")):
                if engine == "multiword":
                    wins = np.lib.stride_tricks.sliding_window_view(
                        encode(gene), k).astype(np.uint8)
                    got = bfs_hashed.run_device_bfs_hashed(
                        wins, kmap, k, 2, hasher, direction, mr, device=dev)
                    outs.append({r.tobytes() for r in got})
                    continue
                seeds = np.array(seed_codes_of_sequences([gene], k, kmap, 2),
                                 np.int64)
                run = (bfs_dense.run_dense_bfs if engine == "dense"
                       else bfs_device.run_device_bfs)
                outs.append(run(seeds, kmap, k, 2, direction, mr,
                                device=dev).tobytes())
            assert outs[0] == outs[1] and len(outs[0]) > 600


@pytest.mark.parametrize("k,env", [
    (31, {"MC_DEVICE_BFS": "1"}),
    (31, {"MC_DEVICE_BFS": "1", "MC_DEVICE_BFS_ENGINE": "probe"}),
    (31, {"MC_COUNT_ENGINE": "hash"}),
    (55, {"MC_DEVICE_BFS": "1"}),
], ids=["dense", "probe", "hash-engine", "multiword"])
def test_device_engines_cli_on_card_matches_cpu(cuda, k, env, tmp_path,
                                                monkeypatch):
    reads = str(tmp_path / "reads.fastq")
    _write_fastq(reads, 13)
    genes = tmp_path / "genes.fasta"
    with open(reads) as fh:
        fh.readline()
        seq = fh.readline().strip()
    genes.write_text(f">g1\n{seq.replace('N', 'A')}\n")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    trees = {}
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("MC_PLATFORM", platform)
        out = tmp_path / f"out_{platform}"
        assert port_main(["-t", "environment-finder", "-k", str(k),
                          "-i", reads, "--seq", str(genes), "-o", str(out),
                          "--coverage", "2", "--maxradius", "300",
                          "--work-dir", str(tmp_path / f"wd_{platform}")]) == 0
        trees[platform] = {
            os.path.relpath(os.path.join(d, n), out): Path(d, n).read_bytes()
            for d, _, names in os.walk(out) for n in names}
    assert trees["cuda"] and trees["cuda"] == trees["cpu"]
