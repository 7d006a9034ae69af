"""bfs_s: seconds of build_environment (seeding, the BFS of both
directions, normalization) summed over a job's genes, averaged over the
window's jobs. The genes run in threads, so this busy time may exceed the
job's wall time."""
from benchmark.tracing import Wrap

WRAPS = (Wrap("metacherchant_tpu_torch.algo.calculator",
              "build_environment", "build_environment"),)


def read(trace):
    return trace.mean_per_job("build_environment")
