"""The port's device hash table (B11) and the `hash` counting engine against
the JAX package and the port's `sort` engine.

Inputs are made from a seed with numpy and handed to both packages. The
tolerance is exact equality everywhere: table contents (items_host, never
slot layout, ROADMAP C4), lookups and counted maps.
"""
import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from metacherchant_tpu import native as jax_native
from metacherchant_tpu.counting import count_kmers_device as jax_count
from metacherchant_tpu.ops import hashtable as JH
from metacherchant_tpu.ops.kmers import canonical_kmers as jax_canonical
from metacherchant_tpu_torch.counting import count_kmers_device
from metacherchant_tpu_torch.kmer_map import KmerMap
from metacherchant_tpu_torch.ops import hashtable as TH
from metacherchant_tpu_torch.ops.kmers import SENTINEL, canonical_kmers

CPU = torch.device("cpu")
I64 = np.iinfo(np.int64)


def _jax_table(batches, capacity_log2):
    jt = JH.DeviceHashTable(capacity_log2=capacity_log2)
    for b in batches:
        pad = np.full(1 << int(np.ceil(np.log2(max(b.size, 2)))), SENTINEL,
                      np.int64)
        pad[:b.size] = b
        jt.insert_batch(jnp.asarray(pad))
    return jt.items_host()


def _port_table(batches, capacity_log2):
    t = TH.DeviceHashTable(CPU, capacity_log2=capacity_log2)
    for b in batches:
        t.insert_batch(torch.from_numpy(b))
    return t


def test_mix64_bit_equal_to_jax():
    """int64 with masked logical shifts against JAX's uint64 finalizer, on
    keys with bit 63 set and the extremes (ROADMAP C1)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(I64.min, I64.max, 200_000,
                                     dtype=np.int64),
                        [I64.min, I64.max, -1, 0, 1]]).astype(np.int64)
    assert (x < 0).sum() > 90_000
    want = np.asarray(JH._mix64(jnp.asarray(x))).view(np.int64)
    assert np.array_equal(TH._mix64(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("case", ["duplicates", "top-bit", "saturation",
                                  "growths"])
def test_table_contents_equal_jax(case):
    rng = np.random.default_rng(1)
    cap = 6
    if case == "duplicates":
        batches = [rng.integers(0, 500, 3000) for _ in range(4)]
    elif case == "top-bit":
        keys = rng.integers(I64.min, I64.max, 300, dtype=np.int64)
        batches = [rng.choice(keys, 2000) for _ in range(3)]
        batches.append(np.array([-5, -5, -1, 0, 7, -(1 << 62), I64.min]))
    elif case == "saturation":
        batches = [np.full(4096, 42)] * 9 + [rng.integers(0, 9, 4096)] * 9
    else:
        cap = 4  # 16 slots: doubles to 2^14
        batches = [rng.integers(-3000, 3000, 3000) for _ in range(5)]
    batches = [np.asarray(b, np.int64) for b in batches]
    t = _port_table(batches, cap)
    keys, counts = t.items_host()
    want_keys, want_counts = _jax_table(batches, cap)
    assert np.array_equal(keys, want_keys)
    assert np.array_equal(counts, want_counts)
    exp = collections.Counter(np.concatenate(batches).tolist())
    assert t.size == len(exp) == keys.size
    assert dict(zip(keys.tolist(), counts.tolist())) == {
        key: min(n, 32767) for key, n in exp.items()}
    if case == "saturation":
        assert counts.max() == 32767
    if case == "growths":
        assert t.capacity >= 1 << 13


def test_lookup_absent_and_sentinel():
    rng = np.random.default_rng(2)
    keys = rng.integers(I64.min, I64.max, 5000, dtype=np.int64)
    t = _port_table([keys, keys[:100]], 8)
    absent = rng.integers(I64.min, I64.max, 1000, dtype=np.int64)
    absent = absent[~np.isin(absent, keys)]
    q = np.concatenate([keys[:300], absent, [SENTINEL]])
    got = t.lookup(torch.from_numpy(q)).numpy()
    assert got.dtype == np.int32
    assert np.all(got[:100] == 2) and np.all(got[100:300] == 1)
    assert np.all(got[300:] == -1)
    want = np.asarray(JH._lookup_kernel(
        jnp.asarray(t.tkeys.numpy()), jnp.asarray(t.tcnts.numpy()),
        jnp.asarray(q)))
    assert np.array_equal(got, want)


def test_from_kmer_map_lookup_matches_get_many():
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(I64.min, I64.max, 20_000, dtype=np.int64))
    kmap = KmerMap(keys, rng.integers(1, 40_000, keys.size))
    t = TH.DeviceHashTable.from_kmer_map(kmap, CPU)
    assert t.size == keys.size and t.capacity == 1 << 17  # load 0.25
    q = np.concatenate([keys[::2], rng.integers(I64.min, I64.max, 5000,
                                                dtype=np.int64), [SENTINEL]])
    assert np.array_equal(t.lookup(torch.from_numpy(q)).numpy(),
                          kmap.get_many(q))
    k, c = t.items_host()
    assert np.array_equal(k, kmap.keys) and np.array_equal(c, kmap.counts)


def test_residual_lane_raises():
    """A key that finds no slot within MAX_PROBE_ROUNDS is reported by
    _insert_unique and raises in the table: no key is dropped silently."""
    t = TH.DeviceHashTable(CPU, capacity_log2=4)
    t.tkeys[:] = torch.arange(16)  # every slot taken by another key
    new, residual = TH._insert_unique(
        t.tkeys, t.tcnts, torch.tensor([100, 101, SENTINEL]),
        torch.ones(3, dtype=torch.int32))
    assert new == 0 and residual.tolist() == [0, 1]
    with pytest.raises(RuntimeError, match="found no slot"):
        t._insert(torch.tensor([100]), torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("k,hasher", [(5, None), (21, None), (31, None),
                                      (21, "poly"), (55, "poly"),
                                      (63, "fnv1a")])
def test_canonical_kmers_match_jax(k, hasher):
    """The dispatch: B1's plain version on the CPU for exact keys, B3 for
    hashed ones; rows with N (-1) codes and -1 padding."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (40, 90)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.03] = -1
    codes[5, 30:] = -1
    keys, ok = canonical_kmers(torch.from_numpy(codes), k, hasher)
    want_keys, want_ok = jax_canonical(jnp.asarray(codes, jnp.int32), k,
                                       hasher)
    assert np.array_equal(keys.numpy(), np.asarray(want_keys))
    assert np.array_equal(ok.numpy(), np.asarray(want_ok))


def test_count_insert_codes_matches_jax():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, (64, 120)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.02] = -1
    t = TH.DeviceHashTable(CPU, capacity_log2=6)
    jt = JH.DeviceHashTable(capacity_log2=6)
    for _ in range(2):
        t.count_insert_codes(torch.from_numpy(codes), 11, None)
        jt.count_insert_codes(jnp.asarray(codes, jnp.int32), 11, None)
    for got, want in zip(t.items_host(), jt.items_host()):
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def reads_fastq(tmp_path_factory):
    """80 bp reads of a 4 kbp genome with N runs, and every 50th read 400 bp
    (chunked at max_len)."""
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), 4000))
    path = tmp_path_factory.mktemp("hash_reads") / "reads.fastq"
    with open(path, "w") as f:
        for i in range(400):
            n = 400 if i % 50 == 0 else 80
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            if i % 7 == 0:
                p = int(rng.integers(0, n - 3))
                r = r[:p] + "N" * int(rng.integers(1, 4)) + r[p + 3:]
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


@pytest.mark.parametrize("native_io", ["1", "0"])
@pytest.mark.parametrize("k,hasher", [(5, None), (21, None), (31, None),
                                      (55, "poly"), (63, "fnv1a")])
def test_hash_engine_matches_jax_and_sort(reads_fastq, k, hasher, native_io,
                                          monkeypatch):
    """MC_COUNT_ENGINE=hash: ragged launches (exact keys, native parser) or
    packed batches (hashed keys, Python readers), a small table that grows,
    against JAX's hash engine and the port's sort engine."""
    monkeypatch.setenv("MC_NATIVE_IO", native_io)
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    geom = dict(batch=64, max_len=96, table_log2=10)
    monkeypatch.setenv("MC_COUNT_ENGINE", "hash")
    got = count_kmers_device([reads_fastq], k, hasher, device=CPU, **geom)
    want = jax_count([reads_fastq], k, hasher, **geom)
    sort = count_kmers_device([reads_fastq], k, hasher, device=CPU,
                              engine="sort", **geom)
    assert len(got) > 500
    for other in (want, sort):
        assert np.array_equal(got.keys, other.keys)
        assert np.array_equal(got.counts, other.counts)
