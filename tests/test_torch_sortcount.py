"""The port's sort-engine StreamCounter against the JAX StreamCounter.

Small capacities force the store to grow several times. All comparisons
are bit-exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from metacherchant_tpu.ops.sortcount import (
    StreamCounter as JaxStreamCounter, _consolidate_full_split)
from metacherchant_tpu_torch.ops.kmers import SENTINEL
from metacherchant_tpu_torch.ops.sortcount import StreamCounter, consolidate

CPU = torch.device("cpu")
CAPS = dict(buffer_cap=4096, store_cap=256)


def _batches(seed: int, n: int, shape=(16, 64), genome_len=20_000):
    """Read batches drawn from one random genome, with N gaps."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(n):
        starts = rng.integers(0, genome_len - shape[1], shape[0])
        b = genome[starts[:, None] + np.arange(shape[1])]
        b[rng.random(shape) < 0.02] = -1
        out.append(b.astype(np.int32))
    return out


def _feed_jax(sc, batches, k):
    for b in batches:
        sc.add_codes(jnp.asarray(b), k, None)


def _feed_port(sc, batches, k):
    for b in batches:
        sc.add_codes(torch.from_numpy(b.astype(np.int8)), k)


@pytest.mark.parametrize("k", [15, 31])
def test_stream_counter_matches_jax_with_growth(k):
    batches = _batches(k, 24)
    jsc = JaxStreamCounter(**CAPS)
    _feed_jax(jsc, batches, k)
    want_keys, want_cnts = jsc.finalize()
    sc = StreamCounter(CPU, **CAPS)
    _feed_port(sc, batches, k)
    keys, cnts = sc.finalize()
    assert sc.store_cap >= 8 * CAPS["store_cap"]  # grew at least 3 times
    assert keys.dtype == np.int64 and cnts.dtype == np.int32
    assert np.array_equal(keys, want_keys)
    assert np.array_equal(cnts, want_cnts)


def test_counts_clamp_at_32767():
    """Poly-A rows put 3200 copies of key 0 in every batch, 35200 in all:
    the count saturates at 32767 in both packages."""
    k = 15
    poly_a = np.zeros((64, 64), np.int32)
    poly_c = np.full((64, 64), 2, np.int32)
    batches = [poly_a] * 11 + [poly_c]
    jsc = JaxStreamCounter(**CAPS)
    _feed_jax(jsc, batches, k)
    want_keys, want_cnts = jsc.finalize()
    sc = StreamCounter(CPU, **CAPS)
    _feed_port(sc, batches, k)
    keys, cnts = sc.finalize()
    assert np.array_equal(keys, want_keys)
    assert np.array_equal(cnts, want_cnts)
    assert keys[0] == 0 and cnts[0] == 32767


def test_from_state_continues_a_jax_counter():
    """Both packages count the same further batches from one shared store
    state that the JAX counter reached."""
    k = 21
    batches = _batches(5, 20)
    first, rest = batches[:9], batches[9:]
    jsc = JaxStreamCounter(**CAPS)
    _feed_jax(jsc, first, k)
    jsc._consolidate()
    jsc._resolve()
    store_keys = np.asarray(jsc.store_keys)
    store_cnts = np.asarray(jsc.store_cnts)
    sc = StreamCounter.from_state(store_keys, store_cnts, CPU,
                                  buffer_cap=4096)
    assert sc.store_cap == store_keys.size
    assert sc.store_keys.numel() == jsc._live
    _feed_jax(jsc, rest, k)
    _feed_port(sc, rest, k)
    want_keys, want_cnts = jsc.finalize()
    keys, cnts = sc.finalize()
    assert np.array_equal(keys, want_keys)
    assert np.array_equal(cnts, want_cnts)


def test_from_state_rejects_unsorted_store():
    keys = np.array([5, 3, SENTINEL], np.int64)
    with pytest.raises(ValueError, match="ascending"):
        StreamCounter.from_state(keys, np.ones(3, np.int32), CPU)


def test_consolidate_matches_jax_split_consolidation():
    """One consolidation (the JAX units prep -> sort2 -> cumsum_mark ->
    sort2 -> diff_finish) against the port's sort + cumsum + mask."""
    rng = np.random.default_rng(9)
    store = np.unique(rng.integers(0, 500, 120))
    cnts = rng.integers(1, 40, store.size).astype(np.int32)
    pad = 256 - store.size
    buf = rng.integers(0, 800, 1024)
    buf[rng.random(1024) < 0.1] = SENTINEL
    offset = 900
    jk, jc, jn = map(np.asarray, _consolidate_full_split(
        jnp.asarray(np.concatenate([store, np.full(pad, SENTINEL)])),
        jnp.asarray(np.concatenate([cnts, np.zeros(pad, np.int32)])),
        jnp.asarray(buf), jnp.int32(offset)))
    keys, counts = consolidate(torch.from_numpy(store),
                               torch.from_numpy(cnts),
                               torch.from_numpy(buf[:offset]))
    n = int(jn)
    assert keys.numel() == n
    assert np.array_equal(keys.numpy(), jk[:n])
    assert np.array_equal(counts.numpy(), jc[:n])
