"""The port's sharded counter against JAX's at world sizes 1-4 (see
test_torch_parallel.py): residual keys of full shards requeued."""
import pytest

from test_torch_parallel import WORLD_SIZES, check_count, results_fixture

results = results_fixture(("requeue",))


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_sharded_residual_requeue(results, n):
    """With the proactive growth bound defeated, shards of 2^5 slots fill up
    mid-step: the keys that find no slot stay in the carry, the shards grow
    at the next sync and the keys land. Growth driven by residuals follows
    the probe bound: JAX's 128 rounds leave residuals in a nearly full
    shard of 512 slots where the port's 1024 find a slot (ROADMAP C11), so
    the port's shards grow as far as JAX's at most."""
    got = results(n)["requeue"]
    jax_cap = check_count(got, "requeue", n)
    caps = {int(res["shard_cap"]) for res in got}
    assert len(caps) == 1 and 32 < caps.pop() <= jax_cap
