"""The port's hashed-regime environment BFS against the JAX package.

Every host route of the port (the native C++ FIFO, and with MC_NATIVE_BFS=0
the scalar sliding-poly FIFO for poly and the layer FIFO for FNV-1a) must
give the JAX package's environment exactly: the same normalized k-mers,
counts, extend count and fail flag.
Inputs are made from a seed with numpy; both packages get the same map
arrays.
"""
import numpy as np
import pytest

from metacherchant_tpu import native as jax_native
from metacherchant_tpu.algo import environment_hashed as JH
from metacherchant_tpu.counting import count_sequences_host
from metacherchant_tpu.dna import encode, reverse_complement
from metacherchant_tpu.kmer_map import KmerMap as JaxKmerMap
from metacherchant_tpu_torch import native
from metacherchant_tpu_torch.algo import environment as TE
from metacherchant_tpu_torch.algo import environment_hashed as TH
from metacherchant_tpu_torch.kmer_map import KmerMap

CFGS = [
    dict(both_directions=False, max_radius=None, max_kmers=None, trim=False),
    dict(both_directions=True, max_radius=None, max_kmers=None, trim=False),
    dict(both_directions=False, max_radius=7, max_kmers=None, trim=False),
    dict(both_directions=False, max_radius=7, max_kmers=None, trim=True),
    dict(both_directions=False, max_radius=None, max_kmers=40, trim=False),
    dict(both_directions=True, max_radius=5, max_kmers=35, trim=True),
]
CFG_IDS = ["plain", "bothdirs", "radius", "radius-trim", "maxkmers",
           "bothdirs-capped-trim"]


def _reads(seed: int, n_reads: int = 60, read_len: int = 90):
    """Reads of a 400 bp genome, half reverse-complemented, and a 60 bp gene
    from it."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 400))
    reads = []
    for _ in range(n_reads):
        i = int(rng.integers(0, len(genome) - read_len))
        r = genome[i:i + read_len]
        reads.append(reverse_complement(r) if rng.random() < 0.5 else r)
    return reads, genome[150:210]


def _setup(seed: int, k: int, hasher: str | None, **kw):
    """The gene and the map of the reads in both packages."""
    reads, gene = _reads(seed, **kw)
    jm = count_sequences_host(reads, k, hasher)
    return gene, jm, KmerMap(jm.keys, jm.counts)


def _same_env(got, want) -> None:
    assert got.fail == want.fail
    assert got.as_dict() == want.as_dict()
    assert got.extend_count == want.extend_count
    assert got.normalized_strings() == want.normalized_strings()


@pytest.mark.parametrize("native_bfs", ["1", "0"], ids=["native", "python"])
@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
@pytest.mark.parametrize("cfg", CFGS, ids=CFG_IDS)
def test_build_environment_hashed_matches_jax(cfg, hasher, native_bfs,
                                              monkeypatch):
    """MC_NATIVE_BFS=0 takes the scalar sliding-poly FIFO for poly and the
    layer FIFO for FNV-1a; the JAX side runs its default engine."""
    k = 33
    gene, jm, tm = _setup(1, k, hasher)
    want = JH.build_environment_hashed([gene], k, jm, 1, hasher, **cfg)
    monkeypatch.setenv("MC_NATIVE_BFS", native_bfs)
    assert native.bfs_available() == (native_bfs == "1")
    got = TH.build_environment_hashed([gene], k, tm, 1, hasher, **cfg)
    assert not want.fail and len(want.as_dict()) > 10
    _same_env(got, want)


@pytest.mark.parametrize("native_bfs", ["1", "0"], ids=["native", "python"])
def test_fail_when_no_seeds_matches_jax(native_bfs, monkeypatch):
    k = 33
    _, jm, tm = _setup(2, k, "poly")
    cfg = dict(both_directions=False, max_radius=None, max_kmers=None,
               trim=False)
    want = JH.build_environment_hashed(["A" * 50], k, jm, 1, "poly", **cfg)
    monkeypatch.setenv("MC_NATIVE_BFS", native_bfs)
    got = TH.build_environment_hashed(["A" * 50], k, tm, 1, "poly", **cfg)
    assert want.fail and got.fail
    _same_env(got, want)


def test_merged_and_hic_seeds_match_jax():
    k = 35
    gene, jm, tm = _setup(3, k, "fnv1a", n_reads=80)
    cfg = dict(both_directions=False, max_radius=9, max_kmers=None, trim=True)
    args = ([gene, gene[::-1]], k)
    want = JH.build_environment_hashed(*args, jm, 2, "fnv1a", **cfg,
                                       hic_sequences=[gene[10:50]])
    got = TH.build_environment_hashed(*args, tm, 2, "fnv1a", **cfg,
                                      hic_sequences=[gene[10:50]])
    _same_env(got, want)


def _seed_rows(k: int, hasher: str):
    """A 4 kbp genome's windows, all in the map at count 3, and the seed rows
    of a 100 bp piece of it, for both packages."""
    rng = np.random.default_rng(17)
    genome = "".join(np.array(list("AGCT"))[rng.integers(0, 4, 4000)])
    wins = np.lib.stride_tricks.sliding_window_view(
        encode(genome), k).astype(np.int8)
    keys = JH.hash_codes_np(wins, hasher)
    jm = JaxKmerMap.from_pairs(keys, np.full(keys.size, 3, np.int64))
    tm = KmerMap(jm.keys, jm.counts)
    swins = np.lib.stride_tricks.sliding_window_view(
        encode(genome[2000:2100]), k).astype(np.uint8)
    seeds = list(swins[JH._occ_block(jm, swins, hasher) >= 3])
    assert np.array_equal(TH._occ_block(tm, swins, hasher),
                          JH._occ_block(jm, swins, hasher))
    return seeds, jm, tm


@pytest.mark.parametrize("direction", [-1, 1, 0])
@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
def test_layer_fifo_matches_jax(hasher, direction):
    """The port's Python engines against the JAX package's, state for
    state, in every direction and termination mode (unbounded, radius with
    trim, max_kmers): the layer FIFO, and for poly the scalar sliding-poly
    FIFO, which builds and then reuses the map's _hash_dict."""
    k = 37
    seeds, jm, tm = _seed_rows(k, hasher)
    for mr, mk, trim in ((None, None, False), (25, None, True),
                         (None, 200, False)):
        got = TH._bfs_layer_fifo(seeds, tm, k, 3, hasher, direction, mr, mk,
                                 trim)
        assert len(got) > 50
        assert set(got) == set(JH._bfs_layer_fifo(seeds, jm, k, 3, hasher,
                                                  direction, mr, mk, trim))
        if hasher == "poly":
            want = JH._bfs_scalar_poly(seeds, jm, k, 3, direction, mr, mk,
                                       trim)
            scalar = TH._bfs_scalar_poly(seeds, tm, k, 3, direction, mr, mk,
                                         trim)
            assert set(scalar) == set(want) == set(got)
            assert all(np.array_equal(scalar[b], want[b]) for b in want)
            assert tm._hash_dict == jm._hash_dict
            assert len(tm._hash_dict) == len(tm)


@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
def test_native_bfs_hashed_matches_jax(hasher):
    k = 41
    seeds, jm, tm = _seed_rows(k, hasher)
    assert native.bfs_available() and jax_native.bfs_available()
    for direction, mr, mk, last in ((0, None, None, False),
                                    (1, 30, None, True),
                                    (-1, None, 150, True)):
        args = (np.stack(seeds), k, 3, direction, mr, mk, hasher, last)
        got = native.bfs_hashed(tm.keys, tm.counts, *args)
        want = jax_native.bfs_hashed(jm.keys, jm.counts, *args)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert {r.tobytes() for r in g} == {r.tobytes() for r in w}
        assert got[0].shape[0] > 50


def test_forcehash_small_k_equals_exact_regime():
    """k <= 31 with a hash walks the same string graph as the exact regime."""
    from metacherchant_tpu_torch.algo.environment import build_environment
    k = 21
    gene, _, hashed = _setup(3, k, "poly", n_reads=50, read_len=70)
    _, _, exact = _setup(3, k, None, n_reads=50, read_len=70)
    for cfg in (CFGS[2], CFGS[1] | dict(trim=True)):
        env_h = TH.build_environment_hashed([gene], k, hashed, 1, "poly",
                                            **cfg)
        env_e = build_environment([gene], k, exact, 1, **cfg)
        assert env_h.as_dict() == env_e.as_dict() and env_h.as_dict()
        assert env_h.extend_count == env_e.extend_count


@pytest.mark.parametrize("var", ["MC_DEVICE_BFS", "MC_DEVICE_BFS_MIN_SEEDS"])
def test_device_bfs_request_raises(var, monkeypatch):
    """Asking for the device BFS (ops/bfs_hashed.py, once refused) now gives
    the JAX package's environment under the same switch: MC_DEVICE_BFS runs
    the multiword engine, MC_DEVICE_BFS_MIN_SEEDS=1 routes this radius-7
    run to it."""
    gene, jm, tm = _setup(1, 33, "poly")
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv(var, "1")
    assert TE.route_device_bfs(10, 7, None, False)
    want = JH.build_environment_hashed([gene], 33, jm, 1, "poly", **CFGS[2])
    got = TH.build_environment_hashed([gene], 33, tm, 1, "poly", **CFGS[2])
    assert not want.fail and len(want.as_dict()) > 10
    _same_env(got, want)
