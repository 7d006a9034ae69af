"""The port's sharded counter against JAX's at world sizes 1-4 (see
test_torch_parallel.py): the overflow carry and a hand-over from JAX."""
import pytest

from test_torch_parallel import WORLD_SIZES, check_count, results_fixture

NAMES = ("carry", "handover")
results = results_fixture(NAMES)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_counter_matches_jax(results, name, n):
    """slack=1: keys that miss their bucket stay in the carry and go again
    next step, never dropped; and a mid-run hand-over from a JAX counter's
    state after half the batches (ShardedCounter.from_state) that drains to
    JAX's map."""
    check_count(results(n)[name], name, n)
