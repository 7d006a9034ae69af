"""The port's bitonic primitives (ops/bitonic.py) against the JAX package's.

The same seeded numpy inputs go through both; every result is compared at
its full length, bit for bit (keys, values, counts and n_real): the
tolerance is zero.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from metacherchant_tpu.ops import bitonic as jb
from metacherchant_tpu_torch.ops import bitonic as tb
from metacherchant_tpu_torch.ops.kmers import SENTINEL

#: (len a, len b): totals that are and are not powers of two
SIZES = [(64, 64), (128, 32), (1, 1), (100, 37), (5, 300)]


def _sorted(rng, n: int, hi: int, sentinels: int = 0) -> np.ndarray:
    """n ascending keys in [0, hi) (duplicates likely), the last
    `sentinels` of them SENTINEL."""
    keys = np.sort(rng.integers(0, hi, n)).astype(np.int64)
    if sentinels:
        keys[-sentinels:] = SENTINEL
    return keys


def _same(jax_out, port_out) -> None:
    jax_out = jax_out if isinstance(jax_out, tuple) else (jax_out,)
    port_out = port_out if isinstance(port_out, tuple) else (port_out,)
    assert len(jax_out) == len(port_out)
    for j, t in zip(jax_out, port_out):
        j, t = np.asarray(j), t.numpy()
        assert j.dtype == t.dtype and j.shape == t.shape
        assert np.array_equal(j, t)


@pytest.mark.parametrize("na,nb", SIZES)
def test_bitonic_merge_keys(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    a = _sorted(rng, na, 1 << 40, sentinels=min(na - 1, 2))
    b = _sorted(rng, nb, 1 << 40)
    got = tb.bitonic_merge(torch.from_numpy(a), torch.from_numpy(b))
    _same(jb.bitonic_merge(jnp.asarray(a), jnp.asarray(b)), got)
    total = na + nb
    assert got.numel() == 1 << (total - 1).bit_length()
    assert np.array_equal(got.numpy()[:total],
                          np.sort(np.concatenate([a, b])))


@pytest.mark.parametrize("na,nb", SIZES)
def test_bitonic_merge_carries_values(na, nb):
    """Values ride with their keys; equal keys keep the order JAX gives."""
    rng = np.random.default_rng(7 + na + nb)
    a, b = _sorted(rng, na, 50), _sorted(rng, nb, 50, sentinels=nb // 4)
    va = rng.integers(0, 1000, na).astype(np.int32)
    vb = rng.integers(0, 1000, nb).astype(np.int32)
    _same(jb.bitonic_merge(*map(jnp.asarray, (a, b, va, vb))),
          tb.bitonic_merge(*map(torch.from_numpy, (a, b, va, vb))))


@pytest.mark.parametrize("n", [1, 6, 256])
def test_seg_totals(n):
    rng = np.random.default_rng(n)
    keys = _sorted(rng, n, max(n // 3, 1), sentinels=n // 10)
    w = rng.integers(0, 5000, n).astype(np.int32)
    _same(jb.seg_totals(jnp.asarray(keys), jnp.asarray(w)),
          tb.seg_totals(torch.from_numpy(keys), torch.from_numpy(w)))


def test_seg_totals_runs():
    keys = np.array([2, 2, 2, 5, 9, 9], np.int64)
    w = np.array([1, 2, 3, 4, 5, 6], np.int32)
    got = tb.seg_totals(torch.from_numpy(keys), torch.from_numpy(w))
    assert got.tolist() == [1, 3, 6, 4, 5, 11]


@pytest.mark.parametrize("n,share", [(8, 0.4), (256, 0.0), (256, 1.0),
                                     (100, 0.4)])
def test_compact_sorted(n, share):
    rng = np.random.default_rng(n)
    keys = _sorted(rng, n, 1 << 40)
    cnts = rng.integers(1, 100, n).astype(np.int32)
    real = rng.random(n) < share
    got = tb.compact_sorted(*map(torch.from_numpy, (keys, cnts, real)))
    _same(jb.compact_sorted(*map(jnp.asarray, (keys, cnts, real))), got)
    nr = int(real.sum())
    assert int(got[2]) == nr
    assert np.array_equal(got[0].numpy()[:nr], keys[real])


def test_exclusive_cumsum_i32():
    x = np.random.default_rng(3).random(256) < 0.5
    _same(jb._exclusive_cumsum_i32(jnp.asarray(x)),
          tb._exclusive_cumsum_i32(torch.from_numpy(x)))


@pytest.mark.parametrize("store_n,run_n", [(128, 128), (100, 60)])
def test_merge_rle_compact(store_n, run_n):
    """A SENTINEL-padded store (some counts above the 1e6 clamp) and a run
    of raw keys with SENTINEL padding: the full-length result, and the map
    against a dict."""
    rng = np.random.default_rng(store_n + run_n)
    skeys = np.unique(rng.integers(0, 600, store_n * 3 // 4))[:store_n - 1]
    scnts = rng.integers(1, 50, skeys.size).astype(np.int32)
    scnts[::7] = 1_500_000
    store_k = np.full(store_n, SENTINEL, np.int64)
    store_c = np.zeros(store_n, np.int32)
    store_k[:skeys.size], store_c[:skeys.size] = skeys, scnts
    raw = rng.integers(0, 900, run_n * 3 // 4).astype(np.int64)
    run = np.full(run_n, SENTINEL, np.int64)
    run[:raw.size] = np.sort(raw)
    got = tb.merge_rle_compact(*map(torch.from_numpy,
                                    (store_k, store_c, run)))
    _same(jb.merge_rle_compact(*map(jnp.asarray, (store_k, store_c, run))),
          got)
    want = {int(k): min(int(c), tb.COUNT_CLAMP) for k, c in zip(skeys, scnts)}
    for x in raw.tolist():
        want[x] = want.get(x, 0) + 1
    nd = int(got[2])
    assert dict(zip(got[0][:nd].tolist(), got[1][:nd].tolist())) == \
        {key: min(c, tb.COUNT_CLAMP) for key, c in want.items()}


def test_count_clamp_is_jax_merge_clamp():
    """The merge engine clamps at 1e6 (not the sort engine's 1e9)."""
    assert tb.COUNT_CLAMP == jb.COUNT_CLAMP == 1_000_000
