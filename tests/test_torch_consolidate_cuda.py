"""The consolidation's CUDA kernel (ops/consolidate_cuda.py) on the card
against its plain version (consolidate), bit for bit: keys, counts and
length, on edge cases of the store, the buffer's fill and the keys, and on
random geometries up to 2^24 lanes; StreamCounter on the card against the
CPU after every batch, with the kernel's launches counted.

They skip where torch sees no CUDA device. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_consolidate_cuda.py
"""
import numpy as np
import pytest
import torch

from metacherchant_tpu_torch import trace
from metacherchant_tpu_torch.ops import consolidate_cuda
from metacherchant_tpu_torch.ops.consolidate_cuda import consolidate
from metacherchant_tpu_torch.ops.kmers import SENTINEL
from metacherchant_tpu_torch.ops.sortcount import StreamCounter

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
CLAMP = 1_000_000_000
INT64_MIN = -(1 << 63)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _store(rng, n: int, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
    keys = np.unique(rng.integers(lo, hi, n, dtype=np.int64))
    return keys, rng.integers(1, 50, keys.size).astype(np.int32)


def _buffer(rng, keys: np.ndarray, n: int, lo: int, hi: int) -> np.ndarray:
    """Half the store's keys (where it has any), half new ones, and 5%
    SENTINEL lanes, as the hashed appends leave for invalid windows."""
    new = rng.integers(lo, hi, n, dtype=np.int64)
    if keys.size:
        old = keys[rng.integers(0, keys.size, n)]
        new = np.where(rng.random(n) < 0.5, old, new)
    new[rng.random(n) < 0.05] = SENTINEL
    return new


def _case(name: str, seed: int):
    """(store keys, store counts, buffer, offset) of a named case."""
    rng = np.random.default_rng(seed)
    lo, hi = 0, 1 << 40
    if name == "empty_store":
        keys, cnts = _store(rng, 0, lo, hi)
        buf = _buffer(rng, keys, 5000, lo, 3000)
        return keys, cnts, buf, buf.size
    if name == "one_lane_store":
        keys, cnts = np.array([77], np.int64), np.array([5], np.int32)
        buf = _buffer(rng, keys, 3000, 0, 200)
        return keys, cnts, buf, buf.size
    if name in ("offset_1", "partial_offset", "full_buffer"):
        keys, cnts = _store(rng, 5000, lo, 20_000)
        buf = _buffer(rng, keys, 8192, lo, 20_000)
        offset = {"offset_1": 1, "partial_offset": 3001,
                  "full_buffer": buf.size}[name]
        return keys, cnts, buf, offset
    if name == "long_run":
        # one key over 10,000 buffer lanes: five 2048-lane tiles and more,
        # and in the store too
        keys, cnts = _store(rng, 3000, lo, 10_000)
        hot = keys[keys.size // 2]
        buf = _buffer(rng, keys, 30_000, lo, 10_000)
        buf[rng.permutation(buf.size)[:10_000]] = hot
        return keys, cnts, buf, buf.size
    if name == "clamp":
        keys, cnts = _store(rng, 4000, lo, 8000)
        cnts[::4] = CLAMP - 1
        cnts[1::4] = CLAMP
        cnts[2::8] = CLAMP + 1
        cnts[3::8] = np.iinfo(np.int32).max
        buf = _buffer(rng, keys, 20_000, lo, 8000)
        return keys, cnts, buf, buf.size
    if name == "negative":
        # hashed regimes' keys span all of int64
        keys, cnts = _store(rng, 6000, INT64_MIN, SENTINEL)
        buf = _buffer(rng, keys, 12_000, INT64_MIN, SENTINEL)
        return keys, cnts, buf, buf.size
    if name == "sentinel_minus_1":
        keys, cnts = _store(rng, 3000, SENTINEL - 5000, SENTINEL)
        keys = np.union1d(keys, [SENTINEL - 1])
        cnts = rng.integers(1, 50, keys.size).astype(np.int32)
        buf = _buffer(rng, keys, 9000, SENTINEL - 6000, SENTINEL)
        buf[::97] = SENTINEL - 1
        return keys, cnts, buf, buf.size - 11
    raise ValueError(name)


CASES = ["empty_store", "one_lane_store", "offset_1", "partial_offset",
         "full_buffer", "long_run", "clamp", "negative", "sentinel_minus_1"]


def _plain(keys, cnts, buf, offset, store_cap):
    return consolidate(keys, cnts, buf[:offset])


def _run(fn, d, keys, cnts, buf, offset, store_cap):
    out = fn(torch.from_numpy(keys).to(d), torch.from_numpy(cnts).to(d),
             torch.from_numpy(buf).to(d), offset, store_cap)
    return [t.cpu() for t in out]


def _same(got, want) -> None:
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_edge_cases(cuda, name):
    """The kernel on the card against the plain version on the card and on
    the CPU."""
    keys, cnts, buf, offset = _case(name, CASES.index(name))
    store_cap = max(keys.size, 1)
    before = trace.counter("consolidate.launches")
    got = _run(consolidate_cuda.merge_into_store, cuda, keys, cnts, buf,
               offset, store_cap)
    assert trace.counter("consolidate.launches") == before + 1
    for d in (cuda, CPU):
        _same(got, _run(_plain, d, keys, cnts, buf, offset, store_cap))
    assert got[0].numel() > 0
    if name == "long_run":
        hot = keys[keys.size // 2]
        at = int(np.searchsorted(got[0].numpy(), hot))
        assert int(got[1][at]) >= 10_000


@pytest.mark.parametrize("seed", range(6))
def test_kernel_matches_plain_on_random_geometries(cuda, seed):
    """Stores of up to 2^23 keys and buffers of up to 2^23 lanes, filled to
    a random offset, at most 2^24 lanes together: the kernel against the
    plain version on the card."""
    rng = np.random.default_rng(100 + seed)
    buf_n = 1 << int(rng.integers(12, 24))
    store_n = int(rng.integers(0, (1 << 24) - buf_n + 1))
    span = int(rng.choice([1 << 20, 1 << 28, 1 << 62]))
    keys, cnts = _store(rng, store_n, -span, span)
    buf = _buffer(rng, keys, buf_n, -span, span)
    offset = int(rng.integers(1, buf_n + 1))
    store_cap = max(keys.size, 1)
    got = _run(consolidate_cuda.merge_into_store, cuda, keys, cnts, buf,
               offset, store_cap)
    _same(got, _run(_plain, cuda, keys, cnts, buf, offset, store_cap))


def _codes(seed: int, rows: int, length: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (rows, length)).astype(np.int8)
    codes[rng.random((rows, length)) < 0.03] = -1
    return codes


def test_stream_counter_merge_route_on_card_matches_cpu(cuda):
    """StreamCounter on the card against the CPU after every batch, with
    store growth. Every consolidation on the card is one launch of the
    kernel."""
    caps = dict(buffer_cap=3 << 14, store_cap=1 << 14)
    counters = {d: StreamCounter(d, **caps) for d in (cuda, CPU)}
    with trace.recording() as rec:
        for seed in range(48):  # batches of 8,320 keys
            codes = torch.from_numpy(_codes(seed, 64, 150))
            for d, sc in counters.items():
                sc.add_codes(codes.to(d), 21)
            gpu, cpu = counters.values()
            assert torch.equal(gpu.store_keys.cpu(), cpu.store_keys)
            assert torch.equal(gpu.store_cnts.cpu(), cpu.store_cnts)
            assert (gpu.buffer_cap, gpu.store_cap) == (cpu.buffer_cap,
                                                       cpu.store_cap)
        got, want = (sc.finalize() for sc in counters.values())
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert gpu.store_cap > caps["store_cap"]
    spans = [s for s in rec.spans if s.name == "count.consolidate"]
    # both counters consolidate at the same batches; the CPU's add no launch
    assert rec.counters["consolidate.launches"] == len(spans) // 2 > 2


def test_stream_counter_loads_the_kernel_when_made(cuda):
    """A counter on the card loads the kernel's library when it is made,
    so that a run's first consolidation pays no build."""
    consolidate_cuda._load_library.cache_clear()
    StreamCounter(cuda, buffer_cap=1 << 10, store_cap=1 << 10)
    assert consolidate_cuda._load_library.cache_info().currsize == 1
