"""The port's counting entry points against the JAX package and the host oracle."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from metacherchant_tpu import native as jax_native
from metacherchant_tpu.counting import (
    count_kmers_device as jax_count_device,
    count_kmers_host as jax_count_host,
    seed_keys_of_sequence as jax_seed_keys)
from metacherchant_tpu.kmer_map import KmerMap as JaxKmerMap
from metacherchant_tpu_torch.counting import (
    count_kmers_device, count_kmers_host, seed_keys_of_sequence)
from metacherchant_tpu_torch.device import device
from metacherchant_tpu_torch.kmer_map import KmerMap

CPU = torch.device("cpu")
# small batches and tables: many batches, long-read chunking, store growth
GEOM = dict(batch=64, max_len=96, table_log2=10)


@pytest.fixture
def no_group_left():
    """Destroys the process group the test formed (the sharded engine forms
    one of world size 1 in this process), so that no later test meets it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reads_fastq(tmp_path_factory):
    """Synthetic FASTQ from a 4 kbp genome: 80 bp reads, N runs of 1-3
    bases, and a few 400 bp reads that chunk at max_len."""
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), 4000))
    reads = []
    for i in range(400):
        n = 400 if i % 50 == 0 else 80
        s = int(rng.integers(0, len(genome) - n))
        r = genome[s:s + n]
        if i % 7 == 0:
            p = int(rng.integers(0, n - 3))
            r = r[:p] + "N" * int(rng.integers(1, 4)) + r[p + 3:]
        reads.append(r[:n])
    path = tmp_path_factory.mktemp("reads") / "reads.fastq"
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


@pytest.mark.parametrize("native_io", ["1", "0"])
@pytest.mark.parametrize("k", [21, 31])
def test_count_kmers_device_matches_jax_and_host(reads_fastq, k, native_io,
                                                 monkeypatch):
    monkeypatch.setenv("MC_NATIVE_IO", native_io)
    # the JAX loader caches its availability decision; force a fresh one
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    got = count_kmers_device([reads_fastq], k, device=CPU, **GEOM)
    want = jax_count_device([reads_fastq], k, None, **GEOM)
    host = jax_count_host([reads_fastq], k)
    port_host = count_kmers_host([reads_fastq], k)
    assert len(got) > 1000
    for other in (want, host, port_host):
        assert np.array_equal(got.keys, other.keys)
        assert np.array_equal(got.counts, other.counts)


def test_default_geometry_matches_jax(reads_fastq):
    got = count_kmers_device([reads_fastq], 25, device=CPU)
    want = jax_count_device([reads_fastq], 25)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)


def test_kmer_map_from_jax_numpy(reads_fastq):
    """Both packages hold the map as numpy arrays: a JAX KmerMap's arrays
    build an equal port KmerMap, with equal lookups."""
    jm = jax_count_host([reads_fastq], 21)
    assert isinstance(jm, JaxKmerMap)
    tm = KmerMap(jm.keys, jm.counts)
    assert np.array_equal(tm.keys, jm.keys)
    assert np.array_equal(tm.counts, jm.counts)
    rng = np.random.default_rng(0)
    q = np.concatenate([jm.keys[::3], rng.integers(0, 1 << 42, 500)])
    assert np.array_equal(tm.get_many(q), jm.get_many(q))
    assert tm.oriented_dict(21) == jm.oriented_dict(21)


def test_seed_keys_of_sequence_matches_jax():
    rng = np.random.default_rng(4)
    seq = "".join(rng.choice(list("ACGT"), 300))
    for k, hasher in ((5, None), (21, None), (31, None), (21, "poly"),
                      (55, "poly"), (63, "fnv1a")):
        assert np.array_equal(seed_keys_of_sequence(seq, k, hasher),
                              jax_seed_keys(seq, k, hasher))


@pytest.mark.parametrize("engine", ["hash", "merge", "chunk", "sharded"])
def test_unported_engines_raise(reads_fastq, engine, monkeypatch,
                                no_group_left):
    """Every engine the port once refused now counts, through
    MC_COUNT_ENGINE: the JAX package's map under the same engine, key for
    key ('merge' is ops/mergecount.MergeCounter and 'chunk'
    ops/sortcount.ChunkedStreamCounter, as in JAX; 'sharded' forms a
    process group of world size 1)."""
    monkeypatch.setenv("MC_COUNT_ENGINE", engine)
    got = count_kmers_device([reads_fastq], 21, device=CPU, **GEOM)
    want = jax_count_device([reads_fastq], 21, None, **GEOM)
    assert len(got) > 1000
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)


def test_unknown_engine_raises(reads_fastq):
    with pytest.raises(ValueError, match="unknown counting engine"):
        count_kmers_device([reads_fastq], 21, device=CPU, engine="bitonic")


@pytest.mark.parametrize("k,hasher", [(55, "poly"), (55, "fnv1a"),
                                      (21, "poly")])
def test_hashed_counting_matches_jax_and_host(reads_fastq, k, hasher):
    """k > 31 and --forcehash (k = 21): device counting of hashed keys, with
    N gaps, chunked long reads and store growth."""
    got = count_kmers_device([reads_fastq], k, hasher, device=CPU, **GEOM)
    want = jax_count_device([reads_fastq], k, hasher, **GEOM)
    host = count_kmers_host([reads_fastq], k, hasher)
    assert len(got) > 1000
    assert k < 32 or (got.keys < 0).any()
    for other in (want, host, jax_count_host([reads_fastq], k, hasher)):
        assert np.array_equal(got.keys, other.keys)
        assert np.array_equal(got.counts, other.counts)


def test_device_choice(monkeypatch):
    """MC_PLATFORM picks the device; cuda (the default) never falls back to
    the CPU."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    assert device() == torch.device("cpu")
    monkeypatch.setenv("MC_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        device()
    monkeypatch.delenv("MC_PLATFORM")
    if torch.cuda.is_available():
        assert device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device()
