"""metacherchant_tpu_torch: the PyTorch/CUDA port of metacherchant_tpu.

The environment-finder main path in the exact (k <= 31) and hashed (k > 31
or --forcehash) regimes: native C++ read parsing, canonical k-mer counting on
an NVIDIA GPU (a hand-written CUDA extraction kernel for exact keys, plain
torch for hashed keys, both feeding a sort-based counter in plain torch),
native C++ FIFO BFS, host unitig contraction and the GFA/FASTA/TSV writers;
and kmer-counter -> reads-classifier, with the classifier's coverage on the
host or, under MC_DEVICE_CLASSIFY, on the GPU.

The package imports torch and numpy only; the JAX package metacherchant_tpu
stays the reference it is tested against. The device is chosen by
MC_PLATFORM (see device.py).
"""

__version__ = "0.1.0"
