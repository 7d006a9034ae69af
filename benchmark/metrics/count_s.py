"""count_s: seconds a job spends in counting, from the tool's call of
count_kmers (parse, B1 launches, consolidations, finalize) until the map is
on the host, averaged over the window's jobs."""
from benchmark.tracing import Wrap

WRAPS = (Wrap("metacherchant_tpu_torch.tools.environment_finder",
              "count_kmers", "count_kmers"),
         Wrap("metacherchant_tpu_torch.tools.kmer_counter",
              "count_kmers", "count_kmers"))


def read(trace):
    return trace.mean_per_job("count_kmers")
