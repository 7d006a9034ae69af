"""The port's device BFS engines (B13 dense, B14 probe, B15 multiword) and
their routing against the JAX package and the host engines.

Maps and seeds are made from a seed with numpy and handed to both packages.
The tolerance is exact equality everywhere: visited sets (the engines
return sorted codes or unordered rows; rows are compared as sets).
"""
import numpy as np
import pytest
import torch

from metacherchant_tpu.algo import environment as JE
from metacherchant_tpu.algo import environment_hashed as JEH
from metacherchant_tpu.counting import count_sequences_host
from metacherchant_tpu.dna import reverse_complement, revcomp_codes_np
from metacherchant_tpu.ops import bfs_dense as JD
from metacherchant_tpu.ops import bfs_device as JP
from metacherchant_tpu.ops import bfs_hashed as JM
from metacherchant_tpu.ops.kmers import hash_codes_np
from metacherchant_tpu_torch.algo import environment as TE
from metacherchant_tpu_torch.algo import environment_hashed as TEH
from metacherchant_tpu_torch.kmer_map import KmerMap
from metacherchant_tpu_torch.ops import bfs_dense as TD
from metacherchant_tpu_torch.ops import bfs_device as TP
from metacherchant_tpu_torch.ops import bfs_hashed as TM

CPU = torch.device("cpu")
RADII = [None, 0, 1, 5]


def _reads(rng, genome: str, n: int, length: int) -> list[str]:
    out = []
    for _ in range(n):
        i = int(rng.integers(0, len(genome) - length))
        r = genome[i:i + length]
        out.append(reverse_complement(r) if rng.random() < 0.5 else r)
    return out


@pytest.fixture(scope="module")
def exact():
    """k = 15 map of reads (7x) from a 3 kbp genome plus a branch of one
    copy sharing 20 bases with it (so min_occ 2 cuts it), both packages'
    maps, and the seeds of a 100 bp gene."""
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    branch = genome[1040:1060] + "".join(rng.choice(list("ACGT"), 200))
    k = 15
    jm = count_sequences_host(_reads(rng, genome, 300, 70) + [branch], k)
    tm = KmerMap(jm.keys, jm.counts)
    seeds = np.array(JE.seed_codes_of_sequences([genome[1000:1100]], k, jm,
                                                1), np.int64)
    return jm, tm, seeds, k


def _absent_code(kmap, k: int) -> int:
    for cand in range(1 << 12):
        canon = min(cand, int(revcomp_codes_np(np.array([cand]), k)[0]))
        if kmap.get(canon) < 0:
            return cand
    raise AssertionError("no absent code")


@pytest.mark.parametrize("min_occ", [1, 2])
@pytest.mark.parametrize("max_radius", RADII, ids=lambda r: f"r{r}")
@pytest.mark.parametrize("direction", [-1, 0, 1])
def test_dense_and_probe_equal_jax_and_layered(exact, direction, max_radius,
                                               min_occ):
    jm, tm, seeds, k = exact
    layered = TE.bfs_layered(seeds, tm, k, min_occ, direction, max_radius)
    jax_layered = JE.bfs_layered(seeds, jm, k, min_occ, direction,
                                 max_radius)
    assert np.array_equal(layered.visited, jax_layered.visited)
    want = np.sort(layered.visited)
    dense = TD.run_dense_bfs(seeds, tm, k, min_occ, direction, max_radius,
                             device=CPU)
    probe = TP.run_device_bfs(seeds, tm, k, min_occ, direction, max_radius,
                              device=CPU)
    assert np.array_equal(dense, want)
    assert np.array_equal(probe, want)
    assert np.array_equal(dense, JD.run_dense_bfs(seeds, jm, k, min_occ,
                                                  direction, max_radius))
    assert np.array_equal(probe, JP.run_device_bfs(
        seeds, jm, k, min_occ, direction, max_radius))
    if max_radius is None:
        fifo = TE.bfs_fifo(seeds.tolist(), tm, k, min_occ, direction, None,
                           None)
        assert np.array_equal(fifo.visited, want)
    assert want.size > seeds.size or max_radius == 0


@pytest.mark.parametrize("max_radius", RADII, ids=lambda r: f"r{r}")
def test_out_of_map_seeds_at_min_occ_zero(exact, max_radius):
    """min_occ 0 admits a seed absent from the map: the dense engine's second
    pass and the probe engine against JAX and the layered engine."""
    jm, tm, seeds, k = exact
    s = np.concatenate([seeds[:20], [_absent_code(tm, k)]]).astype(np.int64)
    for direction in (-1, 0, 1):
        want = np.sort(TE.bfs_layered(s, tm, k, 0, direction,
                                      max_radius).visited)
        assert np.array_equal(want, JE.bfs_layered(s, jm, k, 0, direction,
                                                   max_radius).visited)
        dense = TD.run_dense_bfs(s, tm, k, 0, direction, max_radius,
                                 device=CPU)
        assert np.array_equal(dense, want)
        assert np.array_equal(dense, JD.run_dense_bfs(s, jm, k, 0, direction,
                                                      max_radius))
        assert np.array_equal(TP.run_device_bfs(s, tm, k, 0, direction,
                                                max_radius, device=CPU), want)


def test_dense_min_occ_negative_raises(exact):
    """ROADMAP C5(b): routing ignores min_occ, and the dense engine refuses
    a negative one, as the JAX engine does."""
    jm, tm, seeds, k = exact
    with pytest.raises(ValueError, match="min_occ >= 0"):
        TD.run_dense_bfs(seeds, tm, k, -1, 0, 5, device=CPU)
    with pytest.raises(ValueError):
        JD.run_dense_bfs(seeds, jm, k, -1, 0, 5)


def test_probe_frontier_cap_overflow_raises(exact):
    _, tm, seeds, k = exact
    with pytest.raises(RuntimeError, match="frontier overflow"):
        TP.run_device_bfs(seeds, tm, k, 1, 0, None, frontier_cap=1,
                          device=CPU)
    got = TP.run_device_bfs(seeds, tm, k, 1, 0, None, frontier_cap=4,
                            device=CPU)
    assert np.array_equal(got, TP.run_device_bfs(seeds, tm, k, 1, 0, None,
                                                 device=CPU))


def test_dense_adjacency_exact_size_and_pad_unreachable(exact):
    """No power-of-two padding: 2n oriented nodes, absent neighbors point at
    id 2n, which no bitmap lane holds (ROADMAP C5(a)); every row equals the
    host's neighbor ids, and the graph is cached per map and device."""
    jm, tm, _, k = exact
    g = TD._graph_of(tm, k, CPU)
    assert TD._graph_of(tm, k, CPU) is g
    assert g.left.shape == g.right.shape == (2 * len(tm), 4)
    assert g.left.is_contiguous() and g.right.is_contiguous()
    assert g.pad_id == 2 * len(tm)
    assert g.eligible(0).shape == (2 * len(tm),) and bool(g.eligible(0).all())
    adj = torch.cat([g.left, g.right], dim=1).numpy()
    jg = JD._graph_of(jm, k)  # padded to a power of two, pad id 2 Np
    jadj = np.asarray(jg.adj)[:2 * len(tm)]
    assert np.array_equal(adj, np.where(jadj == jg.pad_id, g.pad_id, jadj))
    keys = tm.keys
    for oid in np.random.default_rng(1).integers(0, 2 * len(tm), 300):
        code = keys[oid >> 1]
        if oid & 1:
            code = revcomp_codes_np(np.array([code]), k)[0]
        nbrs = np.concatenate([TE.neighbors_codes(np.array([code]), k, -1)[0],
                               TE.neighbors_codes(np.array([code]), k, 1)[0]])
        canon = np.minimum(nbrs, revcomp_codes_np(nbrs, k))
        pos = np.minimum(np.searchsorted(keys, canon), len(tm) - 1)
        want = np.where(keys[pos] == canon, 2 * pos + (nbrs != canon),
                        g.pad_id)
        assert np.array_equal(adj[oid], want), oid


def test_empty_map_dense_and_probe():
    empty = KmerMap(np.empty(0, np.int64), np.empty(0, np.int32))
    seeds = np.array([5, 9], np.int64)
    for fn in (TD.run_dense_bfs, TP.run_device_bfs):
        assert np.array_equal(fn(seeds, empty, 15, 0, 0, 3, device=CPU),
                              seeds)


@pytest.mark.parametrize("direction", [-1, 0, 1])
def test_bfs_layered_collect_last_equals_jax(exact, direction):
    jm, tm, seeds, k = exact
    for mr in (None, 4):
        got = TE.bfs_layered(seeds, tm, k, 1, direction, mr,
                             collect_last=True)
        want = JE.bfs_layered(seeds, jm, k, 1, direction, mr,
                              collect_last=True)
        assert np.array_equal(got.visited, want.visited)
        assert np.array_equal(got.last_kmers, want.last_kmers)
        assert got.last_kmers.size


# ---------------------------------------------------------------------------
# multiword engine (k > 31)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [32, 33, 55, 63, 64, 65])
def test_pack_unpack_and_ops_equal_jax(k):
    """Round trip, and _mw_neighbors, _mw_hash, _mw_slot, _last_mask bit for
    bit against JAX's uint64 forms (ROADMAP C1)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(k)
    rows = rng.integers(0, 4, (60, k)).astype(np.uint8)
    packed = TM.pack_rows_np(rows, k)
    assert packed.shape == (60, TM.words_of(k))
    assert np.array_equal(packed, JM.pack_rows_np(rows, k))
    assert np.array_equal(TM.unpack_rows_np(packed, k), rows)
    t = torch.from_numpy(packed.view(np.int64))
    for direction in (-1, 0, 1):
        got = TM._mw_neighbors(t, k, direction).numpy().view(np.uint64)
        assert np.array_equal(got, np.asarray(JM._mw_neighbors(
            jnp.asarray(packed), k, direction)))
    for hasher in ("poly", "fnv1a"):
        got = TM._mw_hash(t, k, hasher).numpy()
        assert np.array_equal(got, hash_codes_np(rows, hasher))
        assert (got < 0).any()
    assert TM._last_mask(k) % (1 << 64) == int(JM._last_mask(k))
    mask = (1 << 20) - 1
    assert np.array_equal(TM._mw_slot(t, mask).numpy(), np.asarray(
        JM._mw_slot(jnp.asarray(packed), jnp.uint64(mask))))


def _hashed_setup(k: int, hasher: str):
    rng = np.random.default_rng(k + len(hasher))
    genome = "".join(rng.choice(list("ACGT"), 500))
    reads = _reads(rng, genome, 60, 100)
    jm = count_sequences_host(reads, k, hasher)
    tm = KmerMap(jm.keys, jm.counts)
    from metacherchant_tpu.dna import encode
    wins = np.lib.stride_tricks.sliding_window_view(
        encode(genome[150:150 + k + 40]), k).astype(np.uint8)
    seeds = wins[jm.get_many(hash_codes_np(wins, hasher)) >= 1]
    return jm, tm, seeds


def _row_set(rows: np.ndarray) -> set[bytes]:
    return {r.tobytes() for r in np.asarray(rows, np.uint8)}


@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
@pytest.mark.parametrize("k", [32, 33, 55, 63, 64])
def test_multiword_engine_equals_jax_and_host(k, hasher):
    jm, tm, seeds = _hashed_setup(k, hasher)
    assert seeds.shape[0] > 10
    for direction, mr in ((-1, None), (0, 6), (1, None), (0, 0)):
        got = TM.run_device_bfs_hashed(seeds, tm, k, 1, hasher, direction, mr,
                                       device=CPU)
        want = JM.run_device_bfs_hashed(seeds, jm, k, 1, hasher, direction,
                                        mr)
        host = TEH._bfs_layer_fifo(list(seeds), tm, k, 1, hasher, direction,
                                   mr, None, False)
        assert _row_set(got) == _row_set(want) == set(host)
        assert got.shape[0] == len(host)
        assert len(host) > seeds.shape[0] or mr == 0


def test_mwset_insert_many_rows_on_few_slots():
    """3000 distinct rows into 4096 slots from one batch, then again: every
    used slot holds an inserted row, each row lands once, and lookups find
    them all (the one-word election, no torn rows)."""
    rng = np.random.default_rng(5)
    rows = np.unique(rng.integers(-(1 << 62), 1 << 62, (3100, 2)), axis=0)
    rows = torch.from_numpy(rows[:3000])
    skeys = torch.zeros((4096, 2), dtype=torch.int64)
    owner = torch.full((4096,), -1, dtype=torch.int32)
    new, won = TM._mwset_insert(skeys, owner, rows)
    assert new == 3000 and bool(won.all())
    new, won = TM._mwset_insert(skeys, owner, rows[::7])
    assert new == 0 and not bool(won.any())
    held = skeys[owner >= 0]
    assert held.shape[0] == 3000
    assert torch.equal(torch.unique(held, dim=0), torch.unique(rows, dim=0))
    other = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (50, 2)))
    both = torch.cat([rows[:50], other])
    new, won = TM._mwset_insert(skeys, owner, both)
    assert new == 50 and torch.equal(won, torch.arange(100) >= 50)


# ---------------------------------------------------------------------------
# routing and the environment builders
# ---------------------------------------------------------------------------

def test_routing_order_dependent_modes_always_host(monkeypatch):
    monkeypatch.setenv("MC_DEVICE_BFS", "1")
    assert not TE.route_device_bfs(10_000, 100, max_kmers=5, trim=False)
    assert not TE.route_device_bfs(10_000, 100, max_kmers=None, trim=True)


def test_routing_force_flags(monkeypatch):
    monkeypatch.setenv("MC_DEVICE_BFS", "1")
    assert TE.route_device_bfs(1, None, None, False)
    monkeypatch.setenv("MC_DEVICE_BFS", "0")
    assert not TE.route_device_bfs(1_000_000, 10, None, False)


def test_routing_no_auto_route_by_default(monkeypatch):
    monkeypatch.delenv("MC_DEVICE_BFS", raising=False)
    monkeypatch.delenv("MC_DEVICE_BFS_MIN_SEEDS", raising=False)
    for n, r in ((3000, 100_000), (100_000, None), (600_000, 1000),
                 (5000, 1000), (100, 1000)):
        assert not TE.route_device_bfs(n, r, None, False)
        assert not JE.route_device_bfs(n, r, None, False)


def test_routing_thresholds_env(monkeypatch):
    monkeypatch.delenv("MC_DEVICE_BFS", raising=False)
    monkeypatch.setenv("MC_DEVICE_BFS_MIN_SEEDS", "10")
    monkeypatch.setenv("MC_DEVICE_BFS_MAX_RADIUS", "50")
    for args, want in (((10, 50), True), ((9, 50), False),
                       ((10, 51), False), ((10, None), False)):
        assert TE.route_device_bfs(*args, None, False) is want
        assert JE.route_device_bfs(*args, None, False) is want


@pytest.mark.parametrize("engine", ["dense", "probe"])
def test_auto_routed_device_environment_equals_host_and_jax(engine,
                                                            monkeypatch):
    k = 15
    rng = np.random.default_rng(33)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    jm = count_sequences_host(_reads(rng, genome, 600, 60), k)
    tm = KmerMap(jm.keys, jm.counts)
    gene = genome[500:2500]
    cfg = dict(min_occ=1, both_directions=False, max_radius=20,
               max_kmers=None, trim=False)
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_DEVICE_BFS_ENGINE", engine)
    monkeypatch.setenv("MC_DEVICE_BFS", "0")
    host = TE.build_environment([gene], k, tm, **cfg)
    monkeypatch.delenv("MC_DEVICE_BFS")
    monkeypatch.setenv("MC_DEVICE_BFS_MIN_SEEDS", "64")
    dev = TE.build_environment([gene], k, tm, **cfg)
    want = JE.build_environment([gene], k, jm, **cfg)
    for env in (dev, want):
        assert np.array_equal(host.codes, env.codes)
        assert np.array_equal(host.counts, env.counts)
        assert host.extend_count == env.extend_count
    assert host.codes.size > 1000


@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
def test_hashed_device_environment_equals_jax(hasher, monkeypatch):
    jm, tm, seeds = _hashed_setup(41, hasher)
    gene = "".join("AGCT"[c] for c in seeds[0]) + "".join(
        "AGCT"[c] for c in seeds[-1])
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_DEVICE_BFS", "1")
    for both, mr in ((False, None), (True, 8)):
        cfg = dict(both_directions=both, max_radius=mr, max_kmers=None,
                   trim=False)
        got = TEH.build_environment_hashed([gene], 41, tm, 1, hasher, **cfg)
        want = JEH.build_environment_hashed([gene], 41, jm, 1, hasher, **cfg)
        assert got.as_dict() == want.as_dict() and got.as_dict()
        assert got.extend_count == want.extend_count
