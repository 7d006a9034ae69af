"""The ragged entry of the extraction kernel and exact counting without
padded batches, against the JAX package and the host oracle.

Every comparison is bit for bit: the work is integer.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from metacherchant_tpu import native as jax_native
from metacherchant_tpu.counting import (
    count_kmers_device as jax_count_device,
    count_kmers_host as jax_count_host)
from metacherchant_tpu.ops import kmers as jk
from metacherchant_tpu_torch import counting
from metacherchant_tpu_torch.counting import count_kmers_device
from metacherchant_tpu_torch.ops import extract_cuda, sortcount
from metacherchant_tpu_torch.ops.extract_cuda import (
    extract_append, extract_append_plain, extract_append_ragged,
    extract_append_ragged_plain, row_offsets)
from metacherchant_tpu_torch.ops.kmers import SENTINEL

CPU = torch.device("cpu")
KS = [1, 3, 16, 17, 21, 31]


def _ragged(seed: int, k: int, rows: int = 150, max_len: int = 300):
    """Rows of random lengths in [k, max_len] at odd, overlapping starts in
    a flat code array with -1 codes inside; returns numpy (codes, starts,
    lens)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(k, max_len + 1, rows)
    starts = 2 * rng.integers(0, 4000, rows) + 1
    codes = rng.integers(0, 4, int((starts + lens).max()) + 7).astype(np.int8)
    codes[rng.random(codes.size) < 0.02] = -1
    return codes, starts.astype(np.int64), lens.astype(np.int32)


def _tensors(codes, starts, lens, k):
    return (torch.from_numpy(codes), torch.from_numpy(starts),
            torch.from_numpy(lens), torch.from_numpy(row_offsets(lens, k)))


@pytest.mark.parametrize("k", KS)
def test_ragged_plain_matches_jax_row_by_row(k):
    """The JAX keys of every row (its first k-1 columns dropped), in row
    order, are what the ragged entry writes."""
    codes, starts, lens = _ragged(k, k)
    width = int(lens.max())
    padded = np.full((starts.size, width), -1, np.int32)
    for r, (s, n) in enumerate(zip(starts, lens)):
        padded[r, :n] = codes[s:s + n]
    jkeys = np.asarray(jk.exact_canonical_kmers(jnp.asarray(padded), k)[0])
    want = np.concatenate([jkeys[r, k - 1:n] for r, n in enumerate(lens)])
    args = _tensors(codes, starts, lens, k)
    for entry in (extract_append_ragged_plain, extract_append_ragged):
        out = torch.full((want.size,), 5, dtype=torch.int64)
        entry(*args, k, out)
        assert np.array_equal(out.numpy(), want)
    assert (want == SENTINEL).any() and (want != SENTINEL).any()


@pytest.mark.parametrize("k", KS)
def test_ragged_and_dense_entries_agree(k):
    """A dense (B, L) batch is the ragged case start r*L, length L."""
    rng = np.random.default_rng(100 + k)
    B, L = 37, max(k, 45)
    dense = rng.integers(0, 4, (B, L)).astype(np.int8)
    dense[rng.random((B, L)) < 0.03] = -1
    want = torch.empty(B * (L - k + 1), dtype=torch.int64)
    extract_append_plain(torch.from_numpy(dense), k, want)
    got = torch.empty_like(want)
    extract_append(torch.from_numpy(dense), k, got)
    assert torch.equal(got, want)
    args = _tensors(dense.reshape(-1), np.arange(B, dtype=np.int64) * L,
                    np.full(B, L, np.int32), k)
    for entry in (extract_append_ragged_plain, extract_append_ragged):
        got = torch.empty_like(want)
        entry(*args, k, got)
        assert torch.equal(got, want)


BAD = ["codes_int32", "starts_int32", "lens_int64", "offs_int32",
       "out_int32", "codes_2d", "short_row", "negative_start", "past_end",
       "offs_not_running_sum", "offs_not_from_0", "out_too_small",
       "out_too_large", "table_sizes", "mixed_devices", "k0", "k32",
       "noncontig"]


@pytest.mark.parametrize("case", BAD)
def test_ragged_rejects_bad_input(case):
    k = 5
    codes = torch.zeros(100, dtype=torch.int8)
    starts = torch.tensor([0, 11, 40], dtype=torch.int64)
    lens = torch.tensor([20, 9, 60], dtype=torch.int32)
    offs = torch.tensor([0, 16, 21], dtype=torch.int64)
    out = torch.empty(16 + 5 + 56, dtype=torch.int64)
    extract_append_ragged(codes, starts, lens, offs, k, out)  # the good call
    if case == "codes_int32":
        codes = codes.to(torch.int32)
    elif case == "starts_int32":
        starts = starts.to(torch.int32)
    elif case == "lens_int64":
        lens = lens.to(torch.int64)
    elif case == "offs_int32":
        offs = offs.to(torch.int32)
    elif case == "out_int32":
        out = out.to(torch.int32)
    elif case == "codes_2d":
        codes = codes.view(10, 10)
    elif case == "short_row":
        lens[1], offs[2] = 4, 16  # the offsets stay a running sum
        out = torch.empty(16 + 0 + 56, dtype=torch.int64)
    elif case == "negative_start":
        starts[0] = -1
    elif case == "past_end":
        lens[2] = 61  # 40 + 61 > 100
        out = torch.empty(16 + 5 + 57, dtype=torch.int64)
    elif case == "offs_not_running_sum":
        offs[2] = 22
    elif case == "offs_not_from_0":
        offs += 1
    elif case == "out_too_small":
        out = out[:-1]
    elif case == "out_too_large":
        out = torch.empty(out.numel() + 1, dtype=torch.int64)
    elif case == "table_sizes":
        lens = lens[:2]
    elif case == "mixed_devices":
        out = torch.empty(out.numel(), dtype=torch.int64, device="meta")
    elif case == "k0":
        k = 0
    elif case == "k32":
        k = 32
    elif case == "noncontig":
        starts = torch.tensor([0, 9, 11, 9, 40, 9], dtype=torch.int64)[::2]
    with pytest.raises(ValueError):
        extract_append_ragged(codes, starts, lens, offs, k, out)


def _write_fastq(path, seed: int) -> None:
    """Reads of 150 bp from a 3 kbp genome with N gaps of 1-3 bases, reads
    of 5-25 bp (shorter than k, or dropped by min_len) and 400 bp reads."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    with open(path, "w") as f:
        for i in range(600):
            n = 400 if i % 40 == 0 else (int(rng.integers(5, 26))
                                         if i % 9 == 0 else 150)
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            if i % 6 == 0 and n > 10:
                p = int(rng.integers(0, n - 3))
                r = r[:p] + "N" * int(rng.integers(1, 4)) + r[p + 3:]
            r = r[:n]
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def _write_input(tmp_path, case: str) -> tuple[str, dict]:
    if case == "fasta_10kbp":
        rng = np.random.default_rng(7)
        path = tmp_path / "genome.fasta"
        path.write_text(">g\n" + "".join(rng.choice(list("ACGT"), 10_000))
                        + "\n")
        return str(path), {}
    path = tmp_path / "reads.fastq"
    if case == "empty":
        path.write_text("")
        return str(path), {}
    _write_fastq(path, 3)
    if case == "fastq_min_len":
        return str(path), {"min_len": 40}
    return str(path), {}


CASES = ["fastq", "fastq_min_len", "fasta_10kbp", "empty", "batch64"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("native_io", ["1", "0"])
@pytest.mark.parametrize("k", [21, 31])
def test_count_kmers_device_matches_jax_and_host(tmp_path, monkeypatch, case,
                                                 native_io, k):
    """N gaps, reads shorter than k, a min_len filter, a 10 kbp one-line
    genome chunked with k-1 overlap, an empty file, and batches of 64 chunks
    in a small buffer: many launches and consolidations."""
    monkeypatch.setenv("MC_NATIVE_IO", native_io)
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    path, kw = _write_input(tmp_path, case)
    if case == "batch64":
        monkeypatch.setenv("MC_COUNT_BATCH", "64")
        monkeypatch.setenv("MC_SORT_BUF_LANES", "20000")
        kw = {"table_log2": 10}
    got = count_kmers_device([path], k, device=CPU, **kw)
    want = jax_count_device([path], k, None, **kw)
    host = jax_count_host([path], k, min_len=kw.get("min_len", 0))
    assert (len(got) == 0) == (case == "empty")
    for other in (want, host):
        assert np.array_equal(got.keys, other.keys)
        assert np.array_equal(got.counts, other.counts)


def test_exact_counting_appends_only_windows(tmp_path, monkeypatch):
    """With the native parser, exact counting packs no (B, L) batch and
    writes no padding: after the first launch the buffer offset is the sum
    of len - k + 1 over its chunks, and no lane holds SENTINEL (the parser
    splits fragments at N, so every window is valid)."""
    monkeypatch.setenv("MC_NATIVE_IO", "1")
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, 4)
    k, batch = 21, 64

    def refuse(*a, **kw):
        raise AssertionError("exact counting packed a padded batch")

    monkeypatch.setattr(counting, "_packed_batches", refuse)
    monkeypatch.setattr(counting, "pack_reads", refuse)
    monkeypatch.setattr(sortcount, "append_codes", refuse)
    chunks = counting._native_chunks(path, k, 0, counting.DEFAULT_LEN)
    assert chunks is not None
    _, _, clen = chunks
    seen = []
    add = sortcount.StreamCounter.add_ragged

    def spy(self, codes, starts, lens, offs, n, kk):
        before = self.offset
        add(self, codes, starts, lens, offs, n, kk)
        seen.append((before, self.offset,
                     self.buf[before:self.offset].clone()))

    monkeypatch.setattr(sortcount.StreamCounter, "add_ragged", spy)
    got = count_kmers_device([path], k, batch=batch, device=CPU)
    assert len(seen) == -(-clen.size // batch)
    before, after, lanes = seen[0]
    assert before == 0
    assert after == int((clen[:batch] - k + 1).sum())
    assert not bool((lanes == SENTINEL).any())
    assert np.array_equal(got.keys, jax_count_host([path], k).keys)


def test_ragged_launch_tables(tmp_path, monkeypatch):
    """Each launch carries one contiguous code slice and its rebased table:
    chunk i of the launch is codes[starts[i]:starts[i] + lens[i]]."""
    monkeypatch.setenv("MC_NATIVE_IO", "1")
    path = tmp_path / "genome.fasta"
    rng = np.random.default_rng(9)
    path.write_text(">g\n" + "".join(rng.choice(list("ACGT"), 5000)) + "\n")
    k, max_len, batch = 31, 256, 8
    chunks = counting._native_chunks(str(path), k, 0, max_len)
    codes, cstart, clen = chunks
    assert clen.max() == max_len and clen.size > batch
    assert np.all(np.diff(cstart) == max_len - (k - 1))
    total = 0
    for i, (dcodes, starts, lens, offs, n) in enumerate(
            counting._to_device(t, k, CPU)
            for t in counting._ragged_tables(chunks, batch, k)):
        cs, cl = cstart[i * batch:(i + 1) * batch], clen[i * batch:
                                                         (i + 1) * batch]
        assert dcodes.numel() == int((cs + cl).max() - cs[0])
        assert lens.dtype == torch.int32 and starts.dtype == torch.int64
        assert np.array_equal(starts.numpy() + cs[0], cs)
        assert np.array_equal(offs.numpy(), row_offsets(cl, k))
        assert n == int((cl - k + 1).sum())
        total += n
    assert total == 5000 - k + 1


def test_ctypes_signatures_match_the_source():
    """The wrapper declares every C parameter of csrc/extract_kmers.cu with
    its width: ctypes passes an undeclared trailing argument as a 32-bit
    int, which would cut a pointer."""
    import ctypes
    import re
    src = extract_cuda.SOURCE.read_text()
    width = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, argtypes in extract_cuda.ARGTYPES.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert params is not None, name
        kinds = [re.sub(r"\s*\w+$", "", p.strip())
                 for p in params.group(1).split(",")]
        assert [width[kind] for kind in kinds] == argtypes, name
