"""The `sharded` counting engine of count_kmers_device at world sizes 1-4
(workers as in test_torch_parallel.py), against JAX's sharded engine and
the host oracle."""
import functools
import os

import numpy as np
import pytest

from metacherchant_tpu.counting import (count_kmers_device as jax_count,
                                        count_kmers_host)
from test_torch_parallel import WORLD_SIZES, results_fixture

GEOM = dict(batch=64, max_len=64, table_log2=14)
ENGINE = {"engine-exact": (21, None), "engine-hashed": (35, "poly")}


def reads_files(workdir) -> list[str]:
    """tests/test_parallel.py's 200 reads of 60 bp from a 500 bp genome,
    half reverse complemented, over three FASTQ files."""
    from metacherchant_tpu.dna import reverse_complement
    rng = np.random.default_rng(41)
    genome = "".join(rng.choice(list("ACGT"), 500))
    paths = [os.path.join(str(workdir), f"r{i}.fastq") for i in range(3)]
    fhs = [open(p, "w") for p in paths]
    for i in range(200):
        s = int(rng.integers(0, len(genome) - 60))
        r = genome[s:s + 60]
        if rng.random() < 0.5:
            r = reverse_complement(r)
        fhs[i % 3].write(f"@r{i}\n{r}\n+\n{'I' * 60}\n")
    for fh in fhs:
        fh.close()
    return paths


def engine_jobs(n: int, workdir) -> dict:
    files = reads_files(workdir)
    return {name: dict(kind="engine", files=files, k=k, hasher=hasher,
                       geom=GEOM) for name, (k, hasher) in ENGINE.items()}


results = results_fixture((), engine_jobs)


@functools.cache
def jax_map(name: str, workdir: str):
    """JAX's sharded engine over its 8-device mesh (the same for every n)."""
    k, hasher = ENGINE[name]
    os.makedirs(workdir, exist_ok=True)
    files = reads_files(workdir)
    want = jax_count(files, k, hasher, engine="sharded", **GEOM)
    host = count_kmers_host(files, k, hasher)
    assert np.array_equal(want.keys, host.keys)
    assert np.array_equal(want.counts, host.counts)
    assert len(want) > 400
    return want


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", ENGINE)
def test_count_kmers_device_sharded_engine(results, name, n,
                                          tmp_path_factory):
    """count_kmers_device(engine='sharded'): each rank counts its own files
    (round-robin over three) and steps empty once they are done; every rank
    returns JAX's map (its sharded engine over its 8-device mesh) and the
    host oracle's."""
    want = jax_map(name, str(tmp_path_factory.getbasetemp() / "jax_reads"))
    for r, res in enumerate(results(n)[name]):
        assert np.array_equal(res["keys"], want.keys), r
        assert np.array_equal(res["cnts"], want.counts), r
