"""The port's `merge` engine (ops/mergecount.MergeCounter) against the JAX
package's, and against the host oracle.

The cases of tests/test_mergecount.py, with the same seeded inputs going
through both packages: the counter's whole state (runs, store lanes, store
size, pending full result) is compared after every batch, the maps at the
end, all bit for bit. Then count_kmers_device(engine="merge") and
environment-finder under MC_COUNT_ENGINE=merge against JAX.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from metacherchant_tpu.counting import count_kmers_device as jax_count
from metacherchant_tpu.ops.mergecount import MergeCounter as JaxMergeCounter
from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch import counting
from metacherchant_tpu_torch.counting import (count_kmers_device,
                                              count_kmers_host)
from metacherchant_tpu_torch.ops.mergecount import MergeCounter
from metacherchant_tpu_torch.runner import main as port_main

CPU = torch.device("cpu")


def _assert_same_state(jmc, mc) -> None:
    assert len(mc._runs) == len(jmc._runs)
    for jr, r in zip(jmc._runs, mc._runs):
        assert np.array_equal(np.asarray(jr), r.numpy())
    assert (mc.store_cap, mc._live) == (jmc.store_cap, jmc._live)
    assert np.array_equal(np.asarray(jmc.store_keys), mc.store_keys.numpy())
    assert np.array_equal(np.asarray(jmc.store_cnts), mc.store_cnts.numpy())
    assert (mc._pending is None) == (jmc._pending is None)
    if mc._pending is not None:
        for j, t in zip(jmc._pending, mc._pending, strict=True):
            assert np.array_equal(np.asarray(j), t.numpy())


def _run_both(jmc, mc, batches, k, hasher=None):
    for b in batches:
        jmc.add_codes(jnp.asarray(b), k, hasher)
        mc.add_codes(torch.from_numpy(b.astype(np.int8)), k, hasher)
        _assert_same_state(jmc, mc)
    want, got = jmc.finalize(), mc.finalize()
    _assert_same_state(jmc, mc)
    assert got[0].dtype == np.int64 and got[1].dtype == np.int32
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    return got


@pytest.mark.parametrize("runs_per_merge", [1, 2, 4])
def test_merge_counter_matches_jax_with_growth(runs_per_merge):
    """Seven batches (an odd count: finalize merges the leftover runs), a
    1024-lane store that must grow; against a dict too."""
    rng = np.random.default_rng(4)
    k = 31
    batches = [rng.integers(0, 4, size=(32, 100)).astype(np.int32)
               for _ in range(7)]
    batches[2][5, 40:43] = -1  # N gaps
    geom = dict(run_cap_log2=12, runs_per_merge=runs_per_merge,
                store_cap_log2=10)
    mc = MergeCounter(CPU, **geom)
    keys, cnts = _run_both(JaxMergeCounter(**geom), mc, batches, k)
    assert mc.store_cap > 1 << 10
    want: dict[int, int] = {}
    for b in batches:
        for row in b:
            for frag in np.split(row, np.flatnonzero(row < 0)):
                counting._count_codes_into(want, frag[frag >= 0], k, None)
    assert dict(zip(keys.tolist(), cnts.tolist())) == want


def test_merge_counter_saturates_at_32767():
    """One poly-A read batch 12 times: the canonical 31-mer's 33,840
    copies saturate at 32767 (the 1e6 clamp on the way in changes
    nothing)."""
    codes = np.zeros((40, 100), np.int32)
    geom = dict(run_cap_log2=12, runs_per_merge=2, store_cap_log2=10)
    keys, cnts = _run_both(JaxMergeCounter(**geom), MergeCounter(CPU, **geom),
                           [codes] * 12, 31)
    assert keys.tolist() == [0] and cnts.tolist() == [32767]


def test_merge_counter_hashed_matches_jax():
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 4, size=(16, 120)).astype(np.int32)
               for _ in range(5)]
    geom = dict(run_cap_log2=11, runs_per_merge=2, store_cap_log2=9)
    _run_both(JaxMergeCounter(**geom), MergeCounter(CPU, **geom), batches,
              63, "poly")


def test_ragged_runs_equal_jax_padded_runs():
    """A run of one ragged launch holds exactly the windows of the padded
    batch of the same chunks (JAX's extra lanes are SENTINEL), so the port
    fed ragged launches stays in JAX's state, fed the packed batches."""
    rng = np.random.default_rng(8)
    lens = rng.integers(25, 90, 300)
    lens[::37] = 10  # too short for k: dropped with its fragment
    offs = np.concatenate([[0], np.cumsum(lens)])
    codes = rng.integers(0, 4, offs[-1]).astype(np.int8)
    k, max_len, batch = 21, 64, 32
    chunks = (codes, *counting._chunk_table(offs, k, 0, max_len))
    geom = dict(run_cap_log2=11, runs_per_merge=2, store_cap_log2=9)
    jmc, mc = JaxMergeCounter(**geom), MergeCounter(CPU, **geom)
    for packed, launch in zip(
            counting._packed_batches(chunks, batch, max_len),
            (counting._to_device(t, k, CPU)
             for t in counting._ragged_tables(chunks, batch, k)),
            strict=True):
        jmc.add_codes(jnp.asarray(packed.astype(np.int32)), k, None)
        mc.add_ragged(*launch, k)
        _assert_same_state(jmc, mc)
    want, got = jmc.finalize(), mc.finalize()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_bad_geometry_raises():
    with pytest.raises(ValueError, match="power of two"):
        MergeCounter(CPU, runs_per_merge=3)
    mc = MergeCounter(CPU, run_cap_log2=8, store_cap_log2=8)
    with pytest.raises(ValueError, match="run capacity"):
        mc.add_codes(torch.zeros((4, 65), dtype=torch.int8), 21)


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


@pytest.mark.parametrize("native_io", ["1", "0"])
@pytest.mark.parametrize("k,hasher", [(21, None), (55, "poly")])
def test_count_kmers_merge_engine_matches_jax(reads_fastq, k, hasher,
                                              native_io, monkeypatch):
    """count_kmers_device(engine='merge') counts with a MergeCounter of
    JAX's geometry: JAX's map and the host oracle's, with the native parser
    (ragged runs) and without it."""
    monkeypatch.setenv("MC_NATIVE_IO", native_io)
    geom = dict(batch=64, max_len=96, table_log2=10)
    made = []

    class Spy(MergeCounter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(counting, "MergeCounter", Spy)
    got = count_kmers_device([reads_fastq], k, hasher, device=CPU,
                             engine="merge", **geom)
    assert [(m.run_cap, m.runs_per_merge) for m in made] == [(1 << 13, 4)]
    want = jax_count([reads_fastq], k, hasher, engine="merge", **geom)
    host = count_kmers_host([reads_fastq], k, hasher)
    assert len(got) > 1000
    for other in (want, host):
        assert np.array_equal(got.keys, other.keys)
        assert np.array_equal(got.counts, other.counts)


@pytest.mark.parametrize("k", [21, 33])
def test_environment_finder_merge_engine_matches_jax(reads_fastq, k,
                                                     tmp_path, monkeypatch):
    """environment-finder under MC_COUNT_ENGINE=merge: the port's files are
    byte-identical to the JAX package's under the same engine."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_COUNT_ENGINE", "merge")
    monkeypatch.setenv("MC_COUNT_BATCH", "64")
    monkeypatch.setenv("MC_COUNT_MAX_LEN", "96")
    genes = tmp_path / "genes.fasta"
    seq = open(reads_fastq).read().split("\n")[1]
    genes.write_text(f">geneA\n{seq[:70]}\n")
    trees = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / name
        assert main(["-t", "environment-finder", "-k", str(k),
                     "-i", reads_fastq, "--seq", str(genes), "-o", str(out),
                     "--coverage", "2", "--maxradius", "60",
                     "--work-dir", str(tmp_path / f"wd_{name}")]) == 0
        trees[name] = {os.path.relpath(os.path.join(d, f), out):
                       open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(out) for f in fs}
    assert trees["port"] == trees["jax"]
    assert len(trees["port"]["geneA/graph.txt"].splitlines()) > 10
