"""The classifier's native read stream (native.ReadStream) and what the
device route keeps of the map.

The stream parses a FASTQ file a batch of reads at a time from a window of
whole lines; its batches, joined, are the JAX package's whole-file parse
(native.parse_reads) and the port's Python reader (iter_dnaq), whatever
the window's size and the batch's, on files with Ns, IUPAC letters, short
and missing quality lines, blank lines, CRLF ends, no final newline and
gzip. On the device route the classifier lets go of the map's host arrays
once the card holds them.
"""
import gzip

import numpy as np
import pytest

from metacherchant_tpu import native as jax_native
from metacherchant_tpu_torch import native
from metacherchant_tpu_torch.io.readers import iter_dnaq
from metacherchant_tpu_torch.kmer_map import KmerMap, _strictly_increasing

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native fastio unavailable")

TEXTS = {
    "plain": ("@r1\nACGTNACGT\n+\nIIIIIIIII\n"
              "@r2 with comment\nRYKMAC\n+\n!!!!!!\n"
              "@r3\nACGT\n+\nII\n"
              "@r4\n\n+\n\n"
              "@r5\nacgt\n+\nIIII\n"),
    "blank_lines": "\n@r1\nACGT\n+\nIIII\n\n\n@r2\nGG\n+\nII\n",
    "crlf": "@r1\r\nACGTA\r\n+\r\nIIIII\r\n@r2\r\nTT\r\n+\r\n#I\r\n",
    "no_final_newline": "@r1\nACGT\n+\nIIII\n@r2\nCCA\n+\nIII",
    "missing_qual": "@r1\nACGT\n+\nIIII\n@r2\nCCAG\n+",
    "header_alone": "@r1\nACGT\n+\nIIII\n@r2",
}


def _random_text(n: int, seed: int = 3) -> str:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = int(rng.integers(0, 90))
        seq = "".join(rng.choice(list("ACGTNacgtRY"), ln))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 41, ln))
        out.append(f"@x{i}\n{seq}\n+\n{qual}\n")
    return "".join(out)


def _stream(path, batch: int, chunk: int):
    """The stream's batches, joined, and the reads each batch held."""
    codes, phred, lens, sizes = [], [], [], []
    with native.ReadStream(str(path), 33, chunk) as rs:
        while True:
            c, p, o = rs.next(batch)
            sizes.append(o.size - 1)
            if o.size == 1:
                break
            codes.append(c)
            phred.append(p)
            lens.append(np.diff(o))
    join = (lambda xs, t: np.concatenate(xs) if xs else np.empty(0, t))
    return (join(codes, np.int8), join(phred, np.int16),
            join(lens, np.int64), sizes)


@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
@pytest.mark.parametrize("name", [*TEXTS, "random", "random_gz"])
def test_read_stream_joins_to_the_whole_file_parse(tmp_path, name, chunk):
    if name.startswith("random"):
        text = _random_text(300)
    else:
        text = TEXTS[name]
    path = tmp_path / ("reads.fastq.gz" if name.endswith("_gz")
                       else "reads.fastq")
    if name.endswith("_gz"):
        with gzip.open(path, "wt", newline="") as fh:
            fh.write(text)
    else:
        path.write_bytes(text.encode())
    codes, phred, offs = jax_native.parse_reads(str(path), 33)
    for batch in (1, 4, 1000):
        got_c, got_p, got_l, sizes = _stream(path, batch, chunk)
        assert np.array_equal(got_c, codes) and got_c.dtype == np.int8
        assert np.array_equal(got_p, phred) and got_p.dtype == np.int16
        assert np.array_equal(got_l, np.diff(offs))
        assert all(s == batch for s in sizes[:-2]) and sizes[-1] == 0
    # a header alone at the end is an empty read to the Python reader and
    # no read to the native parsers, in both packages alike
    if name not in ("random_gz", "header_alone"):
        dnaqs = list(iter_dnaq(str(path), "fastq", "sanger"))
        assert len(dnaqs) == offs.size - 1
        for i, d in enumerate(dnaqs):
            assert np.array_equal(codes[offs[i]:offs[i + 1]], d.codes)
            assert np.array_equal(phred[offs[i]:offs[i + 1]], d.phred)


def test_read_stream_reports_a_missing_file(tmp_path):
    with pytest.raises(native.NativeIOError, match="cannot open"):
        native.ReadStream(str(tmp_path / "absent.fastq"))


@pytest.mark.parametrize("n", [0, 1, 2, 5, 6, 7, 13])
def test_strictly_increasing_by_blocks(n):
    """Blocks of 3 keys: a repeat or a descent at any place, the block
    edges included, is found."""
    keys = np.arange(n, dtype=np.int64) * 10
    assert _strictly_increasing(keys, block=3)
    for i in range(n - 1):
        for bad in (keys[i], keys[i] - 1):
            k = keys.copy()
            k[i + 1] = bad
            assert not _strictly_increasing(k, block=3), (n, i, bad)


def test_map_without_its_host_arrays_looks_up_on_the_device():
    """After release_host the map answers len and device lookups as
    before; a host lookup fails rather than answer from nothing."""
    import torch
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 1 << 40, 500, dtype=np.int64))
    counts = rng.integers(1, 50, keys.size).astype(np.int32)
    kmap = KmerMap(keys.copy(), counts.copy())
    query = np.concatenate([keys[::3], keys[::5] + 1])
    want = kmap.get_many(query)
    kmap.device_arrays(torch.device("cpu"))
    kmap.release_host()
    assert len(kmap) == keys.size
    got = kmap.lookup_device(torch.from_numpy(query))
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(AttributeError):
        kmap.get_many(query)


@pytest.mark.parametrize("order", ["sorted", "shuffled", "with_zeros"])
def test_dump_built_on_the_device_a_chunk_at_a_time(tmp_path, order,
                                                    monkeypatch):
    """A dump in ascending key order (kmer-counter's) becomes a map on the
    device alone, chunks of 7 records at a time, equal to the host's build;
    records of count 0 are dropped as the host drops them; a dump out of
    order is left to the host's sort (None)."""
    import torch
    from metacherchant_tpu_torch.io import writers
    monkeypatch.setattr(writers, "KMERS_BIN_CHUNK", 7)
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(0, 1 << 60, 60, dtype=np.int64))
    counts = rng.integers(1, 30000, keys.size).astype(np.int32)
    if order == "shuffled":
        perm = rng.permutation(keys.size)
        keys, counts = keys[perm], counts[perm]
    elif order == "with_zeros":
        counts[::4] = 0
    rec = np.empty(keys.size, writers.KMERS_BIN_RECORD)
    rec["k"], rec["c"] = keys, counts
    path = str(tmp_path / "d.kmers.bin")
    rec.tofile(path)
    got = KmerMap.from_chunks_on_device(writers.iter_kmers_bin(path),
                                        keys.size, torch.device("cpu"))
    if order == "shuffled":
        assert got is None
        return
    want = KmerMap.from_pairs(*writers.read_kmers_bin(path))
    assert got.keys is None and len(got) == len(want)
    dk, dc = got.device_arrays(torch.device("cpu"))
    assert np.array_equal(dk.numpy(), want.keys)
    assert dc.dtype == torch.int32 and np.array_equal(dc.numpy(),
                                                      want.counts)
