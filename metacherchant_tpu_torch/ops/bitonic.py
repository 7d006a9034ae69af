"""Bitonic merge and compaction primitives in plain torch (the `merge`
engine's consolidation).

Counterpart of metacherchant_tpu/ops/bitonic.py. The JAX package builds
these from static-stride slices and elementwise selects, the ops its TPU
compiler handles at any width; here they are the same passes on tensors, so
that every result is the JAX package's, lane for lane:

  bitonic_merge      log2(N) half-cleaner stages (reshape, compare, where)
  seg_totals         per-run running sums: an int64 cumsum less the sum
                     before each run's head (the values of JAX's segmented
                     (flag, sum) scan)
  compact_sorted     monotone stream compaction by log2(N) left shifts of
                     the binary-decomposed displacement (no scatter)
  merge_rle_compact  one consolidation: sorted store + sorted run of raw
                     keys -> distinct keys at the front with their counts

Keys are int64 throughout, SENTINEL (int64 max) the padding that sorts last;
torch has no uint64 arithmetic, and none is needed.
"""
from __future__ import annotations

import torch

from .kmers import SENTINEL

#: far above the 32767 output saturation (NumUtils.addAndBound) but small
#: enough that a run total (clamped store count + the run's lanes) stays
#: inside int32 (metacherchant_tpu/ops/bitonic.py:33). The sort engine
#: clamps at 1e9 instead; both give the same outputs after 32767.
COUNT_CLAMP = 1_000_000


def _half_clean(keys: torch.Tensor, vals: list[torch.Tensor], stride: int
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """One bitonic half-cleaner stage: compare-exchange at `stride` (ties
    keep their order, as in JAX)."""
    n = keys.numel()
    shape = (n // (2 * stride), 2, stride)
    k2 = keys.view(shape)
    lo, hi = k2[:, 0], k2[:, 1]
    take = lo <= hi
    keys = torch.stack([torch.where(take, lo, hi),
                        torch.where(take, hi, lo)], 1).view(n)
    out_vals = []
    for v in vals:
        v2 = v.view(shape)
        vlo, vhi = v2[:, 0], v2[:, 1]
        out_vals.append(torch.stack([torch.where(take, vlo, vhi),
                                     torch.where(take, vhi, vlo)], 1).view(n))
    return keys, out_vals


def bitonic_merge(ka: torch.Tensor, kb: torch.Tensor,
                  va: torch.Tensor | None = None,
                  vb: torch.Tensor | None = None):
    """Merge two ascending int64 key tensors (SENTINEL padding is fine);
    optional values travel with their keys. The result is padded to the
    next power-of-two length with (SENTINEL, 0): ka, a SENTINEL plateau and
    kb reversed form one bitonic sequence, which the half-cleaner stages
    sort. Returns the keys, or (keys, values) when values are given."""
    total = ka.numel() + kb.numel()
    n = 1 << (total - 1).bit_length()
    pad = n - total
    keys = torch.cat([ka, ka.new_full((pad,), SENTINEL), kb.flip(0)])
    vals = []
    if va is not None:
        vals = [torch.cat([va, va.new_zeros(pad), vb.flip(0)])]
    stride = n // 2
    while stride >= 1:
        keys, vals = _half_clean(keys, vals, stride)
        stride //= 2
    if va is not None:
        return keys, vals[0]
    return keys


def _exclusive_cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Exclusive int32 prefix sum."""
    inc = torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)
    return torch.cat([inc.new_zeros(1), inc[:-1]])


def seg_totals(keys: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Running int32 sums of `weights` within each run of equal adjacent
    keys; the run's total stands at its last lane. An int64 cumsum less the
    cumsum before the run's head: the values of JAX's segmented scan."""
    n = keys.numel()
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    w = weights.to(torch.int64)
    pc = torch.cumsum(w, 0)
    lane = torch.arange(n, device=keys.device)
    head = torch.cummax(torch.where(first, lane, 0), 0).values
    return (pc - (pc - w)[head]).to(torch.int32)


def _shift_stage(keys: torch.Tensor, vals: torch.Tensor, d: torch.Tensor,
                 j: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One compaction stage: every lane whose displacement has bit j moves
    left by 2^j; the lane it leaves becomes (SENTINEL, 0, 0). Monotone
    displacements keep every intermediate position distinct, so no two
    lanes meet (metacherchant_tpu/ops/bitonic.py:107-137)."""
    s = 1 << j
    moving = ((d >> j) & 1) == 1
    arrives = moving[s:]
    out = []
    for x, fill in ((keys, SENTINEL), (vals, 0), (d, 0)):
        y = x.masked_fill(moving, fill)
        y[:-s] = torch.where(arrives, x[s:], y[:-s])
        out.append(y)
    return out[0], out[1], out[2]


def _displacement(real: torch.Tensor) -> torch.Tensor:
    """# holes before each real lane (0 on holes, which never move)."""
    d = _exclusive_cumsum_i32(~real)
    return torch.where(real, d, 0)


def _shift_compact_stages(keys: torch.Tensor, vals: torch.Tensor,
                          d: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """All shift stages, bit 0 up, over a lane count n."""
    n = keys.numel()
    j = 0
    while (1 << j) < n:
        keys, vals, d = _shift_stage(keys, vals, d, j)
        j += 1
    return keys, vals


def compact_sorted(keys: torch.Tensor, cnts: torch.Tensor,
                   real: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move the `real` lanes of ascending keys to the front, in order;
    every other lane becomes (SENTINEL, 0). Returns (keys, int32 counts,
    n_real as a 0-d int32 tensor)."""
    d = _displacement(real)
    keys = torch.where(real, keys, SENTINEL)
    cnts = torch.where(real, cnts, 0).to(torch.int32)
    n_real = real.sum(dtype=torch.int32)
    keys, cnts = _shift_compact_stages(keys, cnts, d)
    return keys, cnts, n_real


def merge_rle_compact(store_keys: torch.Tensor, store_cnts: torch.Tensor,
                      run_keys: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One consolidation: merge a sorted store (keys, counts) with a sorted
    run of raw keys (weight 1 each, SENTINEL weight 0), total each key and
    compact. Returns (keys, counts, n_distinct) at the full power-of-two
    merged length, the distinct keys ascending at the front; no key is
    ever lost."""
    store_w = store_cnts.clamp_max(COUNT_CLAMP).to(torch.int32)
    run_w = (run_keys != SENTINEL).to(torch.int32)
    keys, w = bitonic_merge(store_keys, run_keys, store_w, run_w)
    run_sum = seg_totals(keys, w)
    last = torch.ones_like(keys, dtype=torch.bool)
    last[:-1] = keys[1:] != keys[:-1]
    real = last & (keys != SENTINEL) & (run_sum > 0)
    return compact_sorted(keys, run_sum.clamp_max(COUNT_CLAMP), real)
