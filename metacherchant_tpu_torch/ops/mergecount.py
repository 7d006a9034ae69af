"""MergeCounter: the `merge` counting engine, per-launch sorted runs and
bitonic-merge consolidation, in torch.

Counterpart of metacherchant_tpu/ops/mergecount.py:

  per launch:        extract canonical keys into a SENTINEL-padded run of
                     run_cap lanes and sort it (exact keys through the
                     extraction kernel, ops/extract_cuda.py: one launch per
                     run)
  every R runs:      a pairwise bitonic merge tree over the runs (padded to
                     a power-of-two count with SENTINEL runs), then one
                     merge_rle_compact with the sorted store (ops/bitonic.py)
  finalize:          the same on the leftover runs; counts clamp at 32767
                     (itmo:utils/NumUtils.java:21-26)

The store keeps store_cap lanes, SENTINEL-padded, and doubles off the
n_distinct of the previous consolidation, read back just before the next
one dispatches (_resolve), as in JAX; unlike StreamCounter no buffer is
realigned.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kmer_map import SATURATION
from .bitonic import bitonic_merge, merge_rle_compact
from .kmers import SENTINEL
from .sortcount import append_codes, append_ragged


class MergeCounter:
    """Streaming counter: per-launch sorted runs + bitonic-merge
    consolidation (MC_COUNT_ENGINE=merge)."""

    def __init__(self, device: torch.device, run_cap_log2: int = 20,
                 runs_per_merge: int = 4, store_cap_log2: int = 22):
        if runs_per_merge < 1 or runs_per_merge & (runs_per_merge - 1):
            raise ValueError(f"runs_per_merge must be a power of two; got "
                             f"{runs_per_merge}")
        self.device = torch.device(device)
        self.run_cap = 1 << run_cap_log2
        self.runs_per_merge = runs_per_merge
        self.store_cap = 1 << store_cap_log2
        self.store_keys = torch.full((self.store_cap,), SENTINEL,
                                     dtype=torch.int64, device=self.device)
        self.store_cnts = torch.zeros(self.store_cap, dtype=torch.int32,
                                      device=self.device)
        self._runs: list[torch.Tensor] = []
        self._live = 0
        self._pending = None  # (full_keys, full_cnts, n_distinct)

    def _empty_run(self) -> torch.Tensor:
        return torch.full((self.run_cap,), SENTINEL, dtype=torch.int64,
                          device=self.device)

    def _add_run(self, run: torch.Tensor) -> None:
        self._runs.append(torch.sort(run).values)
        if len(self._runs) >= self.runs_per_merge:
            self._consolidate()

    def add_codes(self, codes: torch.Tensor, k: int,
                  hasher: str | None = None) -> None:
        """A (B, L) int8 code batch as one run (all B·L lanes must fit the
        run, as in JAX, which keeps the k-1 keyless columns as SENTINEL)."""
        n_keys = codes.shape[0] * codes.shape[1]
        if n_keys > self.run_cap:
            raise ValueError(f"batch yields {n_keys} keys > run capacity "
                             f"{self.run_cap}")
        run = self._empty_run()
        if codes.shape[1] >= k:
            append_codes(run, 0, codes, k, hasher)
        self._add_run(run)

    def add_ragged(self, codes: torch.Tensor, starts: torch.Tensor,
                   lens: torch.Tensor, offs: torch.Tensor, n: int,
                   k: int) -> None:
        """One launch of ragged rows (`n` windows) as one run."""
        if n > self.run_cap:
            raise ValueError(f"launch yields {n} keys > run capacity "
                             f"{self.run_cap}")
        run = self._empty_run()
        append_ragged(run, 0, codes, starts, lens, offs, n, k)
        self._add_run(run)

    def _merge_tree(self) -> torch.Tensor:
        runs, self._runs = self._runs, []
        while len(runs) & (len(runs) - 1):  # a power-of-two run count
            runs.append(self._empty_run())
        while len(runs) > 1:
            runs = [bitonic_merge(runs[i], runs[i + 1])
                    for i in range(0, len(runs), 2)]
        return runs[0]

    def _resolve(self) -> None:
        if self._pending is None:
            return
        fk, fc, nd = self._pending
        self._pending = None
        self._live = int(nd)
        while self._live > self.store_cap:
            self.store_cap *= 2
        m = self.store_cap
        if fk.numel() >= m:
            self.store_keys, self.store_cnts = fk[:m], fc[:m]
        else:
            pad = m - fk.numel()
            self.store_keys = torch.cat([fk, fk.new_full((pad,), SENTINEL)])
            self.store_cnts = torch.cat([fc, fc.new_zeros(pad)])

    def _consolidate(self) -> None:
        if not self._runs:
            return
        merged = self._merge_tree()
        self._resolve()
        self._pending = merge_rle_compact(self.store_keys, self.store_cnts,
                                          merged)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Key-sorted (keys, counts) on the host, counts clamped at 32767."""
        self._consolidate()
        self._resolve()
        keys = self.store_keys[:self._live].cpu().numpy()
        cnts = self.store_cnts[:self._live].clamp_max(SATURATION)
        return keys, cnts.cpu().numpy()
