"""The port's `chunk` engine (ops/sortcount.ChunkedStreamCounter) against
the JAX package's, the sort engine and the host oracle.

Padded batches: the counter's state (the wrapped StreamCounter's store,
offset and sizes, the chunk size, the batches held back) is compared with
JAX's after every batch, through default and explicit chunk sizes, a
consolidation that shrinks the buffer (the chunk re-fit after it) and a
last partial chunk. Ragged launches (exact keys, native parser): their
consolidation points are the port's own, so the map is compared with
JAX's and the store with the port's sort engine at every consolidation.
All comparisons are bit-exact.
"""
import os

import numpy as np
import pytest
import torch

from metacherchant_tpu.counting import count_kmers_device as jax_count
from metacherchant_tpu.ops.sortcount import ChunkedStreamCounter as JaxChunked
from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch import counting
from metacherchant_tpu_torch.counting import (count_kmers_device,
                                              count_kmers_host)
from metacherchant_tpu_torch.ops import sortcount
from metacherchant_tpu_torch.ops.sortcount import (ChunkedStreamCounter,
                                                   StreamCounter)
from metacherchant_tpu_torch.runner import main as port_main

CPU = torch.device("cpu")


def _batches(seed: int, n: int, genome_len: int, shape=(16, 40)):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(n):
        starts = rng.integers(0, genome_len - shape[1], shape[0])
        b = genome[starts[:, None] + np.arange(shape[1])]
        b[rng.random(shape) < 0.02] = -1
        out.append(b.astype(np.int32))
    return out


def _jax_store(jsc):
    if jsc._pending is not None:
        fk, fc, nd = (np.asarray(x) for x in jsc._pending)
        return fk[:int(nd)], fc[:int(nd)]
    return (np.asarray(jsc.store_keys)[:jsc._live],
            np.asarray(jsc.store_cnts)[:jsc._live])


def _assert_same_state(jck, ck) -> None:
    keys, cnts = _jax_store(jck.sc)
    assert np.array_equal(ck.sc.store_keys.numpy(), keys)
    assert np.array_equal(ck.sc.store_cnts.numpy(), cnts)
    assert ck.sc.offset == jck.sc._offset_host
    assert (ck.sc.buffer_cap, ck.sc.store_cap) == \
        (jck.sc.buffer_cap, jck.sc.store_cap)
    assert ck.chunk_batches == jck.chunk_batches
    assert len(ck._pending) == len(jck._pending)


def _run_both(jck, ck, batches, k, hasher=None):
    for b in batches:
        jck.add_codes(b, k, hasher)
        ck.add_codes(b.astype(np.int8), k, hasher)
        _assert_same_state(jck, ck)
    want, got = jck.finalize(), ck.finalize()
    _assert_same_state(jck, ck)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    return got


@pytest.mark.parametrize("chunk_batches", [None, 1, 3])
def test_chunked_counter_matches_jax(chunk_batches):
    """11 batches (a partial last chunk), store growth; the map also equals
    the port's sort engine fed the same batches."""
    caps = dict(buffer_cap=4096, store_cap=1024)
    batches = _batches(9, 11, 20_000)
    got = _run_both(JaxChunked(16, 40, chunk_batches=chunk_batches, **caps),
                    ChunkedStreamCounter(16, 40, CPU,
                                         chunk_batches=chunk_batches, **caps),
                    batches, 15)
    sc = StreamCounter(CPU, **caps)
    for b in batches:
        sc.add_codes(torch.from_numpy(b.astype(np.int8)), 15)
    want = sc.finalize()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_chunk_refits_after_the_buffer_shrinks():
    """Buffer 3072 + store 1024 lanes; a store of 1024-2048 keys grows to
    2048 lanes and realigns the total at 4096, shrinking the buffer to 2048:
    the default chunk of 7 batches (2912 lanes) is re-fit to 4 after that
    consolidation, in both packages."""
    caps = dict(buffer_cap=3072, store_cap=1024)
    jck = JaxChunked(16, 40, **caps)
    ck = ChunkedStreamCounter(16, 40, CPU, **caps)
    _run_both(jck, ck, _batches(5, 30, 1500), 15)
    assert ck.sc.buffer_cap == 2048 and ck.chunk_batches == 4


def test_hashed_chunks_match_jax():
    caps = dict(buffer_cap=4096, store_cap=512)
    _run_both(JaxChunked(8, 80, **caps), ChunkedStreamCounter(8, 80, CPU,
                                                              **caps),
              _batches(2, 9, 5000, shape=(8, 80)), 55, "poly")


def test_batch_larger_than_the_buffer_raises_like_jax():
    caps = dict(buffer_cap=256, store_cap=256)
    b = _batches(1, 1, 2000)[0]
    for ck in (JaxChunked(16, 40, **caps),
               ChunkedStreamCounter(16, 40, CPU, **caps)):
        with pytest.raises(ValueError, match="exceeds the append buffer"):
            ck.add_codes(b, 15, None)
    ck = ChunkedStreamCounter(16, 40, CPU, **caps)
    with pytest.raises(ValueError, match="exceeds the append buffer"):
        ck.add_ragged(np.zeros(600, np.int8),
                      np.array([[0], [0], [600]]), 586, 15)


def test_empty_finalize():
    for ck in (JaxChunked(64, 96, buffer_cap=4096, store_cap=1024),
               ChunkedStreamCounter(64, 96, CPU, buffer_cap=4096,
                                    store_cap=1024)):
        keys, counts = ck.finalize()
        assert keys.size == 0 and counts.size == 0


def _chunks(seed: int):
    """A parsed file's codes and chunk table: fragments of 10-300 codes
    (the short ones dropped, the long ones chunked at 64 with k-1 overlap)
    from a 3 kbp genome."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000).astype(np.int8)
    lens = rng.integers(10, 300, 400)
    starts = rng.integers(0, 3000 - 300, 400)
    codes = np.concatenate([genome[s:s + n] for s, n in zip(starts, lens)])
    offs = np.concatenate([[0], np.cumsum(lens)])
    return (codes, *counting._chunk_table(offs, 21, 0, 64))


@pytest.mark.parametrize("chunk_batches", [None, 2])
def test_ragged_chunks_consolidate_like_the_sort_engine(chunk_batches,
                                                        monkeypatch):
    """Ragged launches grouped into one kernel call per buffer fill (or per
    chunk_batches launches): the store equals the sort engine's, fed the
    same launches, at every consolidation; the map equals JAX's chunk
    engine's on the packed batches of the same chunks."""
    chunks = _chunks(3)
    k, batch, max_len = 21, 16, 64
    caps = dict(buffer_cap=2048, store_cap=512)
    calls = []
    append = sortcount.append_ragged

    def spy(buf, offset, codes, starts, lens, offs, n, kk):
        calls.append(n)
        return append(buf, offset, codes, starts, lens, offs, n, kk)

    monkeypatch.setattr(sortcount, "append_ragged", spy)
    ck = ChunkedStreamCounter(batch, max_len, CPU,
                              chunk_batches=chunk_batches, **caps)
    sc = StreamCounter(CPU, **caps)
    launches = list(counting._ragged_tables(chunks, batch, k))
    for (codes, table, n), dev in zip(
            launches, counting._ragged_launches(chunks, batch, k, CPU)):
        before = ck.sc.store_keys
        ck.add_ragged(codes, table, n, k)
        sc.add_ragged(*dev, k)
        if ck.sc.store_keys is not before:  # ck consolidated: so did sc
            assert torch.equal(ck.sc.store_keys, sc.store_keys)
            assert torch.equal(ck.sc.store_cnts, sc.store_cnts)
    got, want = ck.finalize(), sc.finalize()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    n_chunks = len(calls) - len(launches)  # sc's calls are one per launch
    assert sum(calls) == 2 * sum(n for _, _, n in launches)
    if chunk_batches is None:
        assert n_chunks < len(launches) // 3
    else:  # a chunk also ends where the buffer fills
        assert -(-len(launches) // chunk_batches) <= n_chunks < len(launches)
    jck = JaxChunked(batch, max_len, **caps)
    for packed in counting._packed_batches(chunks, batch, max_len):
        jck.add_codes(packed.astype(np.int32), k, None)
    jax_keys, jax_cnts = jck.finalize()
    assert np.array_equal(got[0], jax_keys)
    assert np.array_equal(got[1], jax_cnts)


@pytest.fixture(scope="module")
def reads_fastq(tmp_path_factory):
    """80 bp reads of a 4 kbp genome with N runs, and some 400 bp reads
    that chunk at max_len."""
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), 4000))
    path = tmp_path_factory.mktemp("reads") / "reads.fastq"
    with open(path, "w") as f:
        for i in range(400):
            n = 400 if i % 50 == 0 else 80
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            if i % 7 == 0:
                p = int(rng.integers(0, n - 3))
                r = r[:p] + "N" * int(rng.integers(1, 4)) + r[p + 3:]
            r = r[:n]
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


@pytest.mark.parametrize("native_io", ["1", "0"])
@pytest.mark.parametrize("k,hasher", [(21, None), (55, "poly")])
def test_count_kmers_chunk_engine_matches_jax(reads_fastq, k, hasher,
                                              native_io, monkeypatch):
    """count_kmers_device(engine='chunk') counts with a
    ChunkedStreamCounter: JAX's map under the same engine and the host
    oracle's, with the native parser and without it."""
    monkeypatch.setenv("MC_NATIVE_IO", native_io)
    geom = dict(batch=64, max_len=96, table_log2=10)
    made = []

    class Spy(ChunkedStreamCounter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(counting, "ChunkedStreamCounter", Spy)
    got = count_kmers_device([reads_fastq], k, hasher, device=CPU,
                             engine="chunk", **geom)
    assert len(made) == 1 and made[0].sc.store_keys.numel() == len(got)
    want = jax_count([reads_fastq], k, hasher, engine="chunk", **geom)
    host = count_kmers_host([reads_fastq], k, hasher)
    assert len(got) > 1000
    for other in (want, host):
        assert np.array_equal(got.keys, other.keys)
        assert np.array_equal(got.counts, other.counts)


def test_environment_finder_chunk_engine_matches_jax(reads_fastq, tmp_path,
                                                     monkeypatch):
    """environment-finder under MC_COUNT_ENGINE=chunk: the port's files are
    byte-identical to the JAX package's under the same engine."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_COUNT_ENGINE", "chunk")
    monkeypatch.setenv("MC_COUNT_BATCH", "64")
    monkeypatch.setenv("MC_COUNT_MAX_LEN", "96")
    genes = tmp_path / "genes.fasta"
    seq = open(reads_fastq).read().split("\n")[1]
    genes.write_text(f">geneA\n{seq[:70]}\n")
    trees = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / name
        assert main(["-t", "environment-finder", "-k", "21",
                     "-i", reads_fastq, "--seq", str(genes), "-o", str(out),
                     "--coverage", "2", "--maxradius", "60",
                     "--work-dir", str(tmp_path / f"wd_{name}")]) == 0
        trees[name] = {os.path.relpath(os.path.join(d, f), out):
                       open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(out) for f in fs}
    assert trees["port"] == trees["jax"]
    assert len(trees["port"]["geneA/graph.txt"].splitlines()) > 10
