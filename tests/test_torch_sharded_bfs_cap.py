"""The port's sharded BFS with an explicit frontier_cap against the JAX
package's at world sizes 1-4 (data and workers as in
test_torch_sharded_bfs.py)."""
import numpy as np
import pytest

from metacherchant_tpu.algo.environment import bfs_layered
from metacherchant_tpu.parallel.sharded_bfs import run_sharded_bfs
from test_torch_parallel import WORLD_SIZES, mesh_of
from test_torch_sharded_bfs import (K, REFUSED, cap_jobs, genome_graph,
                                    results_of)

results = results_of(cap_jobs)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", ["cap-generous", "cap-seeds", "cap-layer"])
def test_sharded_bfs_frontier_cap(results, name, n):
    """A generous explicit cap gives bfs_layered's set; a cap below the
    densest shard's unique seeds raises ValueError before the table build,
    and one that fits the seeds but not a layer raises RuntimeError, as
    JAX's does."""
    kmap, cases = genome_graph(n)
    seeds, cap = cases[name]
    try:
        want = run_sharded_bfs(seeds, kmap, K, 1, 0, 6, mesh_of(n),
                               frontier_cap=cap)
    except (ValueError, RuntimeError) as e:
        want = type(e).__name__
    if name in REFUSED:
        assert want == REFUSED[name]
    else:
        assert np.array_equal(
            want, np.sort(bfs_layered(seeds, kmap, K, 1, 0, 6).visited))
    for r, res in enumerate(results(n)[name]):
        if name in REFUSED:
            assert str(res["raised"]) == want, r
        else:
            assert np.array_equal(res["visited"], want), r
