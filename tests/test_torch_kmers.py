"""The port's k-mer extraction and fused append against the JAX package.

All comparisons are bit-exact: the work is integer. The JAX Pallas kernel
runs in interpret mode, as tests/test_pallas.py runs it on the CPU.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from metacherchant_tpu.ops import kmers as jk
from metacherchant_tpu.ops.pallas_kmers import exact_canonical_kmers_pallas
from metacherchant_tpu.ops.sortcount import _append_kernel
from metacherchant_tpu_torch.ops import kmers as tk
from metacherchant_tpu_torch.ops.extract_cuda import extract_append
from metacherchant_tpu_torch.ops.sortcount import append_codes

KS = [3, 15, 16, 17, 31]


def _codes(seed: int, shape=(1024, 40)) -> np.ndarray:
    """int32 codes 0..3 with N gaps and -1 tail padding."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=shape).astype(np.int32)
    codes[rng.random(shape) < 0.05] = -1
    tail = rng.integers(0, shape[1] + 1, shape[0])
    codes[np.arange(shape[1])[None, :] >= tail[:, None]] = -1
    return codes


@pytest.mark.parametrize("k", KS)
def test_exact_canonical_kmers_matches_jax_and_pallas(k):
    codes = _codes(k)
    keys, ok = tk.exact_canonical_kmers(
        torch.from_numpy(codes.astype(np.int8)), k)
    want_k, want_ok = map(np.asarray,
                          jk.exact_canonical_kmers(jnp.asarray(codes), k))
    pal_k, pal_ok = map(np.asarray, exact_canonical_kmers_pallas(
        jnp.asarray(codes), k, interpret=True))
    assert keys.dtype == torch.int64 and ok.dtype == torch.bool
    assert np.array_equal(ok.numpy(), want_ok)
    assert np.array_equal(ok.numpy(), pal_ok)
    assert np.array_equal(keys.numpy(), want_k)
    assert np.array_equal(keys.numpy(), pal_k)


@pytest.mark.parametrize("k", KS)
def test_append_matches_jax_append_kernel(k):
    """Two appends in a row: same buffer contents and offsets as the JAX
    _append_kernel (which also drops the first k-1 key columns)."""
    batches = [_codes(100 + k, (64, 40)), _codes(200 + k, (64, 40))]
    cap = 2 * 64 * (40 - k + 1) + 50
    jbuf, joff = jnp.full((cap,), jk.SENTINEL, jnp.int64), jnp.int32(13)
    buf, off = torch.full((cap,), tk.SENTINEL, dtype=torch.int64), 13
    for b in batches:
        jbuf, joff = _append_kernel(jbuf, joff, jnp.asarray(b), k, None)
        off = append_codes(buf, off, torch.from_numpy(b.astype(np.int8)), k)
        assert off == int(joff)
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))


def test_append_overflow_raises():
    """JAX's dynamic_update_slice clamps an overflowing append silently;
    the port refuses it."""
    buf = torch.full((150,), tk.SENTINEL, dtype=torch.int64)
    codes = torch.zeros((4, 30), dtype=torch.int8)
    assert append_codes(buf, 46, codes, 5) == 150  # exactly fits
    with pytest.raises(ValueError, match="overflows"):
        append_codes(buf, 47, codes, 5)


@pytest.mark.parametrize("case", ["int32", "k32", "k0", "short", "size",
                                  "2d_out", "noncontig"])
def test_extract_append_rejects_bad_input(case):
    codes = torch.zeros((4, 30), dtype=torch.int8)
    k = 5
    out = torch.empty(4 * 26, dtype=torch.int64)
    if case == "int32":
        codes = codes.to(torch.int32)
    elif case == "k32":
        k = 32
        codes = torch.zeros((4, 40), dtype=torch.int8)
        out = torch.empty(4 * 9, dtype=torch.int64)
    elif case == "k0":
        k = 0
    elif case == "short":
        codes = torch.zeros((4, 3), dtype=torch.int8)
    elif case == "size":
        out = torch.empty(4 * 26 + 1, dtype=torch.int64)
    elif case == "2d_out":
        out = out.view(4, 26)
    elif case == "noncontig":
        codes = torch.zeros((30, 4), dtype=torch.int8).t()
    with pytest.raises(ValueError):
        extract_append(codes, k, out)


def test_hashed_regime_not_ported():
    for call in (lambda: tk.keys_of_kmer_strings(["ACGT"], 4, "fnv1a"),
                 lambda: tk.hash_str("ACGT", "poly")):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()


@pytest.mark.parametrize("k", KS)
def test_host_key_helpers_match_jax(k):
    rng = np.random.default_rng(k)
    kmers = ["".join(rng.choice(list("ACGT"), k)) for _ in range(200)]
    got = tk.keys_of_kmer_strings(kmers, k, None)
    assert np.array_equal(got, jk.keys_of_kmer_strings(kmers, k, None))
    assert [tk.hash_str(s, None) for s in kmers[:20]] == \
        [jk.hash_str(s, None) for s in kmers[:20]]
    assert tk._signed((1 << 64) - 5) == jk._signed((1 << 64) - 5) == -5


def test_pack_reads_matches_jax():
    rng = np.random.default_rng(3)
    frags = [rng.integers(0, 4, int(n)).astype(np.int8)
             for n in rng.integers(1, 50, 30)]
    got = tk.pack_reads(frags, 32, 50)
    assert got.dtype == np.int8
    assert np.array_equal(got, jk.pack_reads(frags, 32, 50))
