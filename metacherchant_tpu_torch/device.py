"""The torch device the port runs its device stages on.

MC_PLATFORM is the variable the JAX package already reads
(metacherchant_tpu/__init__.py). Here it takes `cuda` (the default) or `cpu`.
There is no automatic choice: asking for CUDA where no GPU is visible is an
error, never a silent move to the CPU.
"""
from __future__ import annotations

import os

import torch


def device() -> torch.device:
    name = os.environ.get("MC_PLATFORM") or "cuda"
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "MC_PLATFORM=cuda (the default) but torch sees no CUDA "
                "device; set MC_PLATFORM=cpu to run on the CPU")
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"MC_PLATFORM must be 'cuda' or 'cpu'; got {name!r}")
