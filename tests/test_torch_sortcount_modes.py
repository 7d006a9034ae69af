"""The sort engine's one consolidation (ops/consolidate_cuda
.merge_into_store, on the CPU the plain sort-and-reduce) against each of
the JAX package's consolidation routes: `sort2` (with the sort2 or the
MC_SORT_COMPACTION=shift compaction) and `merge` (the merge-split: buffer
sort, bitonic merge, shift compaction), which its `mode` selects.

One consolidation is compared at the same (store, buffer) geometry, at
totals that are and are not powers of two and on edge cases, the JAX
result cut to its n_distinct; StreamCounter runs are compared after every
batch (store, offset, buffer and store sizes) against the JAX counter in
each mode. All comparisons are bit-exact: keys, counts and n_distinct.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from metacherchant_tpu.counting import count_kmers_device as jax_count
from metacherchant_tpu.ops import sortcount as js
from metacherchant_tpu_torch.counting import count_kmers_device
from metacherchant_tpu_torch.ops import consolidate_cuda
from metacherchant_tpu_torch.ops import sortcount as ts
from metacherchant_tpu_torch.ops.consolidate_cuda import merge_into_store
from metacherchant_tpu_torch.ops.kmers import SENTINEL

CPU = torch.device("cpu")


def _geometry(seed: int, store_n: int, buf_n: int, offset: int):
    """A store of store_n lanes (distinct keys, SENTINEL behind, counts up
    to 2e9 so that the 1e9 clamp shows) and a buffer of buf_n lanes filled
    to `offset`, SENTINEL lanes inside."""
    rng = np.random.default_rng(seed)
    skeys = np.unique(rng.integers(0, 3000, store_n))[:store_n * 3 // 4]
    store = np.full(store_n, SENTINEL, np.int64)
    cnts = np.zeros(store_n, np.int32)
    store[:skeys.size] = skeys
    cnts[:skeys.size] = rng.integers(1, 40, skeys.size)
    cnts[:skeys.size:9] = 2_000_000_000
    buf = rng.integers(0, 4000, buf_n).astype(np.int64)
    buf[rng.random(buf_n) < 0.1] = SENTINEL
    return store, cnts, buf, offset


GEOMETRIES = [(256, 768, 700), (256, 700, 700), (512, 512, 3),
              (1024, 3072, 3072)]
EDGE_CASES = ["empty_store", "offset_1", "full_store_new_keys",
              "clamp_repeats"]


def _case(case):
    """(store, counts, buffer, offset) of a geometry (store lanes, buffer
    lanes, offset) or of a named edge case (512 + 512 lanes): an empty
    store; a buffer filled to one lane; a store with no SENTINEL lane and a
    buffer of new keys only; buffer keys repeated onto store counts at or
    near the 1e9 clamp."""
    if not isinstance(case, str):
        store_n, buf_n, offset = case
        return _geometry(store_n + buf_n, store_n, buf_n, offset)
    rng = np.random.default_rng(EDGE_CASES.index(case))
    store = np.full(512, SENTINEL, np.int64)
    cnts = np.zeros(512, np.int32)
    buf = rng.integers(0, 4000, 512).astype(np.int64)
    offset = 512
    if case == "offset_1":
        store, cnts, buf, _ = _geometry(5, 512, 512, 512)
        offset = 1
    elif case == "full_store_new_keys":
        store = np.sort(rng.choice(4000, 512, replace=False)).astype(np.int64)
        cnts = rng.integers(1, 40, 512).astype(np.int32)
        buf = rng.integers(4000, 6000, 512).astype(np.int64)
    elif case == "clamp_repeats":
        keys = np.sort(rng.choice(4000, 300, replace=False)).astype(np.int64)
        store[:300] = keys
        cnts[:300] = rng.choice([999_999_990, 1_000_000_000, 2_000_000_000,
                                 np.iinfo(np.int32).max], 300)
        buf = keys[rng.integers(0, 300, 512)]
    buf[rng.random(buf.size) < 0.1] = SENTINEL
    return store, cnts, buf, offset


def _same(jax_out, port_out) -> None:
    for j, t in zip(jax_out, port_out, strict=True):
        j, t = np.asarray(j), t.numpy()
        assert j.dtype == t.dtype and j.shape == t.shape
        assert np.array_equal(j, t)


#: the JAX package's consolidation routes: (function, MC_SORT_COMPACTION)
JAX_ROUTES = {"full_split_sort2": (js._consolidate_full_split, "sort2"),
              "full_split_shift": (js._consolidate_full_split, "shift"),
              "merge_split": (js._consolidate_merge_split, "sort2")}


@pytest.mark.parametrize("route", list(JAX_ROUTES))
@pytest.mark.parametrize("case", GEOMETRIES + EDGE_CASES)
def test_merge_into_store_on_cpu_matches_every_jax_route(case, route,
                                                         monkeypatch):
    """The port's one consolidation on CPU tensors, given the compact
    store, against each JAX route on the store padded to store_cap, cut
    to its n_distinct (the shift compaction applies at power-of-two
    totals only)."""
    store, cnts, buf, off = _case(case)
    fn, compaction = JAX_ROUTES[route]
    monkeypatch.setenv("MC_SORT_COMPACTION", compaction)
    live = int(np.count_nonzero(store != SENTINEL))
    got = merge_into_store(torch.from_numpy(store[:live]),
                           torch.from_numpy(cnts[:live]),
                           torch.from_numpy(buf), off, store.size)
    jk, jc, jnd = fn(jnp.asarray(store), jnp.asarray(cnts),
                     jnp.asarray(buf), jnp.int32(off))
    jnd = int(jnd)
    assert jnd == got[0].numel() > 0
    _same((np.asarray(jk)[:jnd], np.asarray(jc)[:jnd]), got)


def _bad_merge_args(case: str):
    """merge_into_store's arguments, broken one way."""
    keys = torch.arange(8, dtype=torch.int64)
    cnts = torch.ones(8, dtype=torch.int32)
    buf = torch.arange(16, dtype=torch.int64)
    args = dict(store_keys=keys, store_cnts=cnts, buf=buf, offset=16,
                store_cap=8)
    args.update({
        "keys_int32": dict(store_keys=keys.to(torch.int32)),
        "cnts_int64": dict(store_cnts=cnts.to(torch.int64)),
        "lengths": dict(store_cnts=cnts[:7]),
        "over_cap": dict(store_cap=7),
        "offset_0": dict(offset=0),
        "offset_past": dict(offset=17),
        "buf_2d": dict(buf=buf.reshape(4, 4)),
        "strided": dict(buf=torch.arange(32, dtype=torch.int64)[::2]),
    }[case])
    return args


@pytest.mark.parametrize("case", ["keys_int32", "cnts_int64", "lengths",
                                  "over_cap", "offset_0", "offset_past",
                                  "buf_2d", "strided"])
def test_merge_into_store_rejects_bad_arguments(case):
    with pytest.raises(ValueError):
        merge_into_store(**_bad_merge_args(case))


def test_merge_into_store_has_no_route_off_cpu_and_cuda():
    """A tensor on a device with no kernel raises; nothing falls back."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no consolidation kernel"):
        merge_into_store(torch.empty(4, dtype=torch.int64, **meta),
                         torch.empty(4, dtype=torch.int32, **meta),
                         torch.empty(8, dtype=torch.int64, **meta), 8, 4)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_stream_counter_off_cuda_loads_no_kernel(device, monkeypatch):
    """Only a counter on a CUDA device loads the merge kernel's library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(consolidate_cuda, "_library", refuse)
    ts.StreamCounter(torch.device(device), buffer_cap=64, store_cap=64)


def test_consolidate_ctypes_signatures_match_the_source():
    """The wrapper declares every C parameter of csrc/consolidate.cu with
    its width: ctypes passes an undeclared argument as a 32-bit int, which
    would cut a pointer or a lane count."""
    import ctypes
    import re
    src = consolidate_cuda.SOURCE.read_text()
    width = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong}
    assert consolidate_cuda.ARGTYPES
    for name, argtypes in consolidate_cuda.ARGTYPES.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert params is not None, name
        kinds = [re.sub(r"\s*\w+$", "", p.strip())
                 for p in params.group(1).split(",") if p.strip()]
        assert [width[kind] for kind in kinds] == argtypes, name


def _batches(seed: int, n: int, genome_len: int, shape=(16, 64)):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(n):
        starts = rng.integers(0, genome_len - shape[1], shape[0])
        b = genome[starts[:, None] + np.arange(shape[1])]
        b[rng.random(shape) < 0.02] = -1
        out.append(b.astype(np.int32))
    return out


def _jax_map(jsc):
    """The JAX counter's latest store: its pending result, or its view."""
    if jsc._pending is not None:
        fk, fc, nd = (np.asarray(x) for x in jsc._pending)
        return fk[:int(nd)], fc[:int(nd)]
    live = jsc._live
    return np.asarray(jsc.store_keys)[:live], np.asarray(jsc.store_cnts)[:live]


def _assert_same_state(jsc, sc) -> None:
    keys, cnts = _jax_map(jsc)
    assert np.array_equal(sc.store_keys.numpy(), keys)
    assert np.array_equal(sc.store_cnts.numpy(), cnts)
    assert sc.offset == jsc._offset_host
    assert (sc.buffer_cap, sc.store_cap) == (jsc.buffer_cap, jsc.store_cap)


def _run_both(jsc, sc, batches, k):
    for b in batches:
        jsc.add_codes(jnp.asarray(b), k, None)
        sc.add_codes(torch.from_numpy(b.astype(np.int8)), k)
        _assert_same_state(jsc, sc)
    want = jsc.finalize()
    got = sc.finalize()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert (sc.buffer_cap, sc.store_cap) == (jsc.buffer_cap, jsc.store_cap)


@pytest.mark.parametrize("compaction", ["sort2", "shift"])
@pytest.mark.parametrize("mode", ["auto", "sort2", "merge"])
def test_stream_counter_modes_match_jax(mode, compaction, monkeypatch):
    """The port's counter against the JAX counter in each of its modes
    after every batch, with store growth (the store doubles at least twice)
    and its odd transitional total."""
    monkeypatch.setenv("MC_SORT_COMPACTION", compaction)
    caps = dict(buffer_cap=3072, store_cap=1024)
    jsc = js.StreamCounter(mode=mode, **caps)
    sc = ts.StreamCounter(CPU, **caps)
    _run_both(jsc, sc, _batches(3, 14, 8000), 21)
    assert sc.store_cap >= 4 * caps["store_cap"]  # grew twice or more


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


@pytest.mark.parametrize("k,hasher", [(21, None), (55, "poly")])
def test_count_kmers_shift_compaction_matches_jax(reads_fastq, k, hasher,
                                                  monkeypatch):
    """count_kmers_device against the JAX package's under
    MC_SORT_COMPACTION=shift, which the port ignores (the default geometry
    keeps buffer + store a power of two)."""
    monkeypatch.setenv("MC_SORT_COMPACTION", "shift")
    geom = dict(batch=64, max_len=96, table_log2=10)
    got = count_kmers_device([reads_fastq], k, hasher, device=CPU, **geom)
    want = jax_count([reads_fastq], k, hasher, **geom)
    assert len(got) > 1000
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)
