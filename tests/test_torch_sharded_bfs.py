"""The port's sharded BFS (parallel/sharded_bfs.py) against the JAX
package's on a mesh of the same n and against bfs_layered, at world sizes
1-4 (workers as in test_torch_parallel.py): every direction with and
without a radius. test_torch_sharded_bfs_cap.py holds the frontier_cap
cases."""
import functools
import os

import numpy as np
import pytest

from metacherchant_tpu.algo.environment import (bfs_layered,
                                                seed_codes_of_sequences)
from metacherchant_tpu.counting import (count_sequences_host,
                                        seed_keys_of_sequence)
from metacherchant_tpu.dna import reverse_complement
from metacherchant_tpu.parallel.sharded_bfs import run_sharded_bfs
from test_torch_parallel import WORLD_SIZES, mesh_of, run_workers

K = 15
WALKS = [(d, r) for d in (-1, 1, 0) for r in (None, 5)]
REFUSED = {"cap-seeds": "ValueError", "cap-layer": "RuntimeError"}


def reads_graph() -> tuple:
    """tests/test_parallel.py's reads graph: 120 reads of 60 bp from a 600
    bp genome, half reverse complemented; seeds from a 60 bp gene."""
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), 600))
    reads = []
    for _ in range(120):
        i = rng.integers(0, len(genome) - 60)
        r = genome[i:i + 60]
        reads.append(reverse_complement(r) if rng.random() < 0.5 else r)
    kmap = count_sequences_host(reads, K)
    seeds = np.array(seed_codes_of_sequences([genome[200:260]], K, kmap, 1),
                     np.int64)
    return kmap, seeds


def genome_graph(n: int) -> tuple:
    """An 800 bp genome's k-mers with dispersed seeds: 300 for the generous
    cap, every window for the refused seed load, and 40 per shard, which
    fit a cap of 64 while a layer's new states do not."""
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), 800))
    kmap = count_sequences_host([genome], K)
    fw = seed_keys_of_sequence(genome, K, None)
    return kmap, {
        "cap-generous": (np.unique(fw[rng.choice(fw.size, 300,
                                                 replace=False)]), 4096),
        "cap-seeds": (np.unique(fw), 64),
        "cap-layer": (np.unique(fw[rng.choice(fw.size, 40 * n,
                                              replace=False)]), 64)}


def walk_jobs(n: int, workdir) -> dict:
    kmap, seeds = reads_graph()
    data = os.path.join(str(workdir), "reads.npz")
    np.savez(data, keys=kmap.keys, counts=kmap.counts, seeds=seeds)
    return {f"walk{d}{r}": dict(kind="bfs", data=data, k=K, direction=d,
                                radius=r, frontier_cap=None)
            for d, r in WALKS}


def cap_jobs(n: int, workdir) -> dict:
    kmap, cases = genome_graph(n)
    jobs = {}
    for name, (seeds, cap) in cases.items():
        data = os.path.join(str(workdir), f"{name}.npz")
        np.savez(data, keys=kmap.keys, counts=kmap.counts, seeds=seeds)
        jobs[name] = dict(kind="bfs", data=data, k=K, direction=0, radius=6,
                          frontier_cap=cap, expect=REFUSED.get(name))
    return jobs


def results_of(jobs_of):
    """A module fixture: per world size, the workers' results of
    jobs_of(n, workdir)."""
    @pytest.fixture(scope="module")
    def results(tmp_path_factory):
        cache = {}

        def get(n: int) -> dict:
            if n not in cache:
                wd = tmp_path_factory.mktemp(f"bfs{n}")
                cache[n] = run_workers(n, jobs_of(n, wd), wd)
            return cache[n]
        return get
    return results


results = results_of(walk_jobs)


@functools.cache
def jax_walk(direction: int, radius: int | None) -> np.ndarray:
    """JAX's sharded BFS on a mesh of 4 (its set does not depend on n),
    checked against bfs_layered."""
    kmap, seeds = reads_graph()
    want = bfs_layered(seeds, kmap, K, 1, direction, radius).visited
    assert want.size > seeds.size
    got = run_sharded_bfs(seeds, kmap, K, 1, direction, radius, mesh_of(4))
    assert np.array_equal(got, want)
    return got


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("direction,radius", WALKS)
def test_sharded_bfs_matches_jax_and_host(results, direction, radius, n):
    want = jax_walk(direction, radius)
    for r, res in enumerate(results(n)[f"walk{direction}{radius}"]):
        assert np.array_equal(res["visited"], want), r
