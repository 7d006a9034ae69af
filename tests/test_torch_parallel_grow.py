"""The port's sharded counter against JAX's at world sizes 1-4 (see
test_torch_parallel.py): shard growth and adversarial skew."""
import pytest

from test_torch_parallel import WORLD_SIZES, check_count, results_fixture

NAMES = ("growth", "skew")
results = results_fixture(NAMES)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_counter_matches_jax(results, name, n):
    """growth: shards of 2^6 slots overfill and double, with JAX's shard
    capacity; skew: every key owned by shard 0, so the fixed bucket
    capacity keeps a carry that drain() empties."""
    check_count(results(n)[name], name, n, cap_too=name == "growth")
