"""The port's native FIFO BFS (csrc/bfs.cpp) against its Python engines
and against the JAX package's native library.

The native engine looks each count up in the map's sorted keys
(std::lower_bound) and must replicate the Python FIFO engines state for
state -- including the order-dependent MAX_KMERS admission
(TerminationMode.java:38-39) and lastKmers marking
(OneSequenceCalculator.java:209) -- in the exact regime (directions -1, 0
and 1, under caps and trimming) and in the hashed regime (poly and fnv1a,
whose keys are signed 64-bit hashes of either sign). On the same keys,
counts and seeds it must also return what the JAX package's library
returns, which looks counts up in a table of the whole map. A native call
builds no table and counts nothing.
"""
import unittest.mock as mock

import numpy as np
import pytest

from metacherchant_tpu import native as jax_native
from metacherchant_tpu.algo import environment as jax_env
from metacherchant_tpu.kmer_map import KmerMap as JaxKmerMap
from metacherchant_tpu_torch import native, trace
from metacherchant_tpu_torch.algo import environment_hashed as envh_mod
from metacherchant_tpu_torch.algo.environment import (
    bfs_fifo, build_environment, seed_codes_of_sequences, trim_paths)
from metacherchant_tpu_torch.counting import count_sequences_host
from metacherchant_tpu_torch.dna import encode
from metacherchant_tpu_torch.kmer_map import KmerMap

pytestmark = pytest.mark.skipif(
    not (native.bfs_available() and jax_native.bfs_available()),
    reason="native bfs unavailable")


def _random_seqs(rng, n=30, lo=60, hi=220):
    return ["".join(rng.choice(list("ACGT"), size=rng.integers(lo, hi)))
            for _ in range(n)]


def _python_bfs_fifo(seed_list, kmap, k, min_occ, direction, max_radius,
                     max_kmers, collect_last):
    """Run the pure-Python FIFO engine (native path disabled)."""
    with mock.patch.object(native, "bfs_available", return_value=False):
        return bfs_fifo(seed_list, kmap, k, min_occ, direction,
                        max_radius, max_kmers, collect_last)


def _bfs(regime: str, *args):
    """The port's native FIFO in `regime`, held to the JAX package's native
    library on the same arguments, array for array, order included; and
    recorded, to show that it builds no table and counts nothing."""
    with trace.recording() as rec:
        got = getattr(native, "bfs_" + regime)(*args)
    assert rec.counters == {}
    want = getattr(jax_native, "bfs_" + regime)(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    return got


def _padded(kmap: KmerMap, k: int, extra: int, seed: int) -> KmerMap:
    """kmap with `extra` random canonical keys more, so the searches run
    over a map far larger than the walk, and every count drawn from 1-4,
    so that a count read wrong moves what a coverage of 2 admits."""
    rng = np.random.default_rng(seed)
    keys = np.concatenate([kmap.keys, rng.integers(
        0, 1 << (2 * k), extra, dtype=np.int64)])
    return KmerMap.from_pairs(keys, rng.integers(1, 5, keys.size))


@pytest.mark.parametrize("direction", [-1, 1, 0])
@pytest.mark.parametrize("caps", [
    (None, None, False),
    (5, None, False),
    (None, 40, False),
    (3, None, True),
    (None, 25, True),
    (4, 60, True),
])
def test_exact_engine_equals_python(direction, caps):
    max_radius, max_kmers, collect_last = caps
    rng = np.random.default_rng(42)
    seqs = _random_seqs(rng)
    k = 15
    kmap = count_sequences_host(seqs, k)
    seeds = seed_codes_of_sequences(seqs[:2], k, kmap, 1)
    want = _python_bfs_fifo(seeds, kmap, k, 1, direction,
                            max_radius, max_kmers, collect_last)
    got_vis, got_last = _bfs(
        "exact", kmap.keys, kmap.counts, np.asarray(seeds, np.int64), k, 1,
        direction, max_radius, max_kmers, collect_last)
    assert np.array_equal(got_vis, want.visited)
    assert np.array_equal(got_last, want.last_kmers)


@pytest.mark.parametrize("direction", [-1, 1, 0])
def test_exact_engine_equals_python_on_a_large_map(direction):
    """200k keys, of which the walk meets a few hundred, at coverage 2."""
    rng = np.random.default_rng(9)
    seqs = _random_seqs(rng, n=40, lo=150, hi=400)
    k = 19
    kmap = _padded(count_sequences_host(seqs, k), k, 200_000, 9)
    seeds = seed_codes_of_sequences(seqs[:3], k, kmap, 2)
    want = _python_bfs_fifo(seeds, kmap, k, 2, direction, 30, 2000, True)
    got_vis, got_last = _bfs(
        "exact", kmap.keys, kmap.counts, np.asarray(seeds, np.int64), k, 2,
        direction, 30, 2000, True)
    assert got_vis.size > 100
    assert np.array_equal(got_vis, want.visited)
    assert np.array_equal(got_last, want.last_kmers)


def test_exact_engine_trim_path_equal():
    rng = np.random.default_rng(7)
    seqs = _random_seqs(rng, n=20)
    k = 13
    kmap = count_sequences_host(seqs, k)
    seeds = seed_codes_of_sequences(seqs[:1], k, kmap, 1)
    for direction in (-1, 1):
        want = _python_bfs_fifo(seeds, kmap, k, 1, direction, 8, None, True)
        got_vis, got_last = _bfs(
            "exact", kmap.keys, kmap.counts, np.asarray(seeds, np.int64), k,
            1, direction, 8, None, True)
        assert np.array_equal(got_vis, want.visited)
        assert np.array_equal(got_last, want.last_kmers)
        want_keep = trim_paths(want.visited, want.last_kmers, k, direction)
        got_keep = trim_paths(got_vis, got_last, k, direction)
        assert np.array_equal(got_keep, want_keep)


def _hashed_seed_rows(seqs, kmap, k, hasher):
    rows = []
    for s in seqs:
        wins = np.lib.stride_tricks.sliding_window_view(
            encode(s), k).astype(np.uint8)
        rows.extend(wins[envh_mod._occ_block(kmap, wins, hasher) >= 1])
    return rows


@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
@pytest.mark.parametrize("direction", [-1, 1, 0])
def test_hashed_engine_equals_layer_engine(hasher, direction):
    rng = np.random.default_rng(3)
    seqs = _random_seqs(rng, n=15, lo=80, hi=160)
    k = 41
    kmap = count_sequences_host(seqs, k, hasher=hasher)
    assert kmap.keys[0] < 0 < kmap.keys[-1]  # signed hashes, both signs
    seed_rows = _hashed_seed_rows(seqs[:2], kmap, k, hasher)
    want = envh_mod._bfs_layer_fifo(seed_rows, kmap, k, 1, hasher,
                                    direction, None, None, trim=False)
    got_vis, _ = _bfs("hashed", kmap.keys, kmap.counts, np.stack(seed_rows),
                      k, 1, direction, None, None, hasher, False)
    got = {row.tobytes() for row in got_vis}
    assert got == set(want.keys())


@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
def test_hashed_engine_caps_and_trim_equal(hasher):
    rng = np.random.default_rng(11)
    seqs = _random_seqs(rng, n=12, lo=90, hi=150)
    k = 37
    kmap = count_sequences_host(seqs, k, hasher=hasher)
    seed_rows = _hashed_seed_rows(seqs[:1], kmap, k, hasher)
    for max_radius, max_kmers, trim in [(6, None, False), (None, 30, False),
                                        (5, None, True), (None, 20, True)]:
        want = envh_mod._bfs_layer_fifo(
            seed_rows, kmap, k, 1, hasher, 0, max_radius, max_kmers, trim)
        got_vis, got_last = _bfs(
            "hashed", kmap.keys, kmap.counts, np.stack(seed_rows), k, 1, 0,
            max_radius, max_kmers, hasher, trim)
        rows = {row.tobytes(): row for row in got_vis}
        if trim:
            keep = envh_mod._trim(rows, {r.tobytes() for r in got_last}, 0)
            rows = {b: rows[b] for b in keep}
        assert set(rows.keys()) == set(want.keys()), (max_radius, max_kmers,
                                                      trim)


def test_build_environment_native_equals_python():
    """build_environment: the native FIFO against MC_NATIVE_BFS=0's path,
    and against the JAX package's build_environment on the same map."""
    rng = np.random.default_rng(5)
    seqs = _random_seqs(rng, n=25)
    k = 17
    kmap = count_sequences_host(seqs, k)
    jkmap = JaxKmerMap(kmap.keys, kmap.counts)
    gene = [seqs[0]]
    for both, trim, mr, mk in [(False, False, None, None),
                               (True, True, 10, None),
                               (False, False, None, 50)]:
        got = build_environment(gene, k, kmap, 1, both, mr, mk, trim)
        with mock.patch.object(native, "bfs_available", return_value=False):
            want = build_environment(gene, k, kmap, 1, both, mr, mk, trim)
        assert np.array_equal(got.codes, want.codes)
        assert np.array_equal(got.counts, want.counts)
        assert got.extend_count == want.extend_count
        jax = jax_env.build_environment(gene, k, jkmap, 1, both, mr, mk, trim)
        assert np.array_equal(got.codes, jax.codes)
        assert np.array_equal(got.counts, jax.counts)
        assert got.extend_count == jax.extend_count
