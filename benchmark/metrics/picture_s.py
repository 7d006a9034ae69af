"""picture_s: seconds of create_picture (the node graph, the contraction,
seqs.fasta, graph.gfa and the tables) summed over a job's genes, averaged
over the window's jobs."""
from benchmark.tracing import Wrap

WRAPS = (Wrap("metacherchant_tpu_torch.algo.calculator",
              "create_picture", "create_picture"),)


def read(trace):
    return trace.mean_per_job("create_picture")
