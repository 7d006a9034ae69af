"""Multi-device k-mer counting: reads split over ranks, table hash-sharded (B16).

Counterpart of metacherchant_tpu/parallel/sharded_count.py, XLA ops under
shard_map in the JAX package (no Pallas kernel), so plain torch plus
torch.distributed here, one process per device (parallel/distributed.py).
Every rank is both a reads worker and the owner of one table shard: a key
belongs to rank mix64(key) mod n. Per step, on every rank:

  1. extract the keys of this rank's block of reads (B1, the CUDA kernel of
     ops/extract_cuda, for exact keys; B3 for hashed ones) and append the
     overflow carry;
  2. sum the counts per distinct key (sort + segment sum);
  3. pack them into (n, cap) buckets by owner, cap = ceil(lanes / n) * slack
     with `lanes` the padded length the JAX step sees, so cap is the same on
     every rank and in JAX; keys ranked >= cap in their bucket stay in the
     carry and go again next step, never dropped;
  4. one all_to_all_single of the buckets (keys and counts together);
  5. sum per distinct key again and insert into the local shard
     (ops/hashtable._insert_unique); keys that find no slot join the carry,
     and the host grows every shard before they go again.

Decisions that must agree across ranks (growth, the carry's overflow, the
drain's end) use all-reduced values, so every rank makes the same
collective calls in the same order. The map is the same for any n: counts
are commutative sums, and which slot a key takes is only a layout detail.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kmer_map import SATURATION
from ..ops.extract_cuda import extract_append_ragged
from ..ops.hashtable import EMPTY, _insert_unique, _mix64, _srl
from ..ops.kmers import SENTINEL, canonical_kmers
from ..ops.sortcount import consolidate


def _owner(keys: torch.Tensor, n: int) -> torch.Tensor:
    """mix64(key) mod n as the JAX package's uint64 remainder (ROADMAP C13):
    torch's int64 % disagrees with it on keys whose mix has bit 63 set, so
    the two 32-bit halves are reduced apart. int64 owners in [0, n)."""
    h = _mix64(keys)
    hi, lo = _srl(h, 32), h & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def _owner_slots(owner: torch.Tensor, cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A stable order of the lanes by owner, and in that order each lane's
    bucket slot owner * cap + its rank within the owner, or -1 where that
    rank is >= cap (JAX's ranking by an associative max-scan, as cummax)."""
    order = torch.argsort(owner, stable=True)
    so = owner[order]
    idx = torch.arange(so.numel(), device=owner.device)
    first = torch.ones_like(so, dtype=torch.bool)
    first[1:] = so[1:] != so[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    return order, torch.where(rank < cap, so * cap + rank, -1)


def _bucket_by_owner(keys: torch.Tensor, counts: torch.Tensor, n: int,
                     cap: int) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Pack ascending distinct (keys, counts) into (n, cap, 2) int64 buckets
    of (key, count), SENTINEL/0 padded, by owner; within an owner keys keep
    their order and those ranked >= cap are returned as the overflow
    (keys, counts), as JAX's _bucket_by_owner ranks them."""
    order, slot = _owner_slots(_owner(keys, n), cap)
    sk, sc = keys[order], counts[order]
    ok = slot >= 0
    out = torch.zeros((n * cap, 2), dtype=torch.int64, device=keys.device)
    out[:, 0] = SENTINEL
    out[slot[ok], 0] = sk[ok]
    out[slot[ok], 1] = sc[ok].to(torch.int64)
    return out.view(n, cap, 2), sk[~ok], sc[~ok]


def _all_reduce(values: list[int], op=dist.ReduceOp.MAX, *,
                device: torch.device) -> list[int]:
    t = torch.tensor(values, dtype=torch.int64, device=device)
    dist.all_reduce(t, op=op)
    return t.tolist()


def _grown(tkeys: torch.Tensor, tcnts: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """JAX's make_grow_step on one shard: twice the capacity, the live
    entries re-inserted (owners do not depend on capacity). Returns the new
    (tkeys, tcnts) and the live size."""
    live = tkeys != EMPTY
    nk = torch.full((2 * tkeys.numel(),), EMPTY, dtype=torch.int64,
                    device=tkeys.device)
    nc = torch.zeros(2 * tkeys.numel(), dtype=torch.int32,
                     device=tkeys.device)
    new, residual = _insert_unique(nk, nc, tkeys[live], tcnts[live])
    if residual.numel():  # pragma: no cover - twice the room of the old shard
        raise RuntimeError("sharded counter: shard growth lost keys")
    return nk, nc, new


def all_gather_items(keys: torch.Tensor, counts: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (keys, counts) on every rank, concatenated in rank order
    (padded to the longest with SENTINEL for the one all_gather)."""
    n = dist.get_world_size()
    (most,) = _all_reduce([keys.numel()], device=keys.device)
    mine = torch.zeros((most, 2), dtype=torch.int64, device=keys.device)
    mine[:, 0] = SENTINEL
    mine[:keys.numel(), 0] = keys
    mine[:keys.numel(), 1] = counts.to(torch.int64)
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine)
    both = torch.cat(parts)
    live = both[:, 0] != SENTINEL
    return both[live, 0], both[live, 1]


class ShardedCounter:
    """Multi-device streaming counter; this rank's shard and carry.

    Overflow discipline (no key is ever silently lost), as in JAX:
    - shard overflow: keys that found no slot stay in the carry; the next
      sync grows every shard (x2, local re-insert) and the carry sends them
      again. Growth is triggered ahead by a host bound (the largest shard at
      the last sync plus keys sent since) and after the fact by the step's
      table flag.
    - carry overflow (more distinct carried keys than overflow_buf, possible
      only under adversarial bucket skew): RuntimeError at the next sync.
    """

    def __init__(self, k: int, hasher: str | None = None,
                 capacity_log2_per_shard: int = 16, batch: int = 1024,
                 max_len: int = 256, overflow_buf: int = 4096,
                 max_load: float = 0.65, slack: int = 2, *,
                 device: torch.device):
        self.k = k
        self.hasher = hasher
        self.n = dist.get_world_size()
        self.device = torch.device(device)
        self.batch = batch
        self.max_len = max_len
        self.overflow_buf = overflow_buf
        self.max_load = max_load
        self.slack = slack
        self.shard_cap = 1 << capacity_log2_per_shard
        self.tkeys = torch.full((self.shard_cap,), EMPTY, dtype=torch.int64,
                                device=self.device)
        self.tcnts = torch.zeros(self.shard_cap, dtype=torch.int32,
                                 device=self.device)
        self.ov_keys = torch.empty(0, dtype=torch.int64, device=self.device)
        self.ov_cnts = torch.empty(0, dtype=torch.int32, device=self.device)
        self.size = 0              # live keys of this shard
        self._max_confirmed = 0    # largest shard at the last sync
        self._pending = 0          # bound on keys sent since the last sync
        self._table_ovf = False
        self._carry_ovf = False

    @classmethod
    def from_state(cls, tkeys: np.ndarray, tcnts: np.ndarray,
                   ov_keys: np.ndarray, ov_cnts: np.ndarray, k: int,
                   hasher: str | None = None, **kw) -> "ShardedCounter":
        """Start this rank from row `rank` of another counter's (n, cap)
        shards and (n, overflow_buf) carry, e.g. a JAX ShardedCounter's
        np.asarray(sc.tkeys), ... on a mesh of the same n, read after its
        last sync (its pending flags are not carried). The shard is taken
        slot for slot: both packages probe linearly from mix64(key) mod cap.
        Every rank calls it."""
        tkeys, tcnts = np.asarray(tkeys, np.int64), np.asarray(tcnts, np.int32)
        ov_keys = np.asarray(ov_keys, np.int64)
        n, cap = tkeys.shape
        if n != dist.get_world_size() or cap & (cap - 1):
            raise ValueError(f"{n} shards of {cap} slots: need one per rank "
                             f"and a power of two")
        rank = dist.get_rank()
        kw.setdefault("overflow_buf", ov_keys.shape[1])
        sc = cls(k, hasher, capacity_log2_per_shard=cap.bit_length() - 1,
                 **kw)
        sc.tkeys = torch.from_numpy(tkeys[rank].copy()).to(sc.device)
        sc.tcnts = torch.from_numpy(tcnts[rank].copy()).to(sc.device)
        sc.size = int((tkeys[rank] != EMPTY).sum())
        carried = ov_keys[rank] != SENTINEL
        ck = torch.from_numpy(ov_keys[rank][carried]).to(sc.device)
        sc.ov_keys, sc.ov_cnts = consolidate(
            ck, torch.from_numpy(np.asarray(ov_cnts, np.int32)[rank][carried])
            .to(sc.device), ck[:0])
        (sc._max_confirmed,) = _all_reduce([sc.size], device=sc.device)
        return sc

    # -- growth and syncs ----------------------------------------------------
    def _sync(self) -> None:
        """All-reduce the largest shard and both flags; raise or grow."""
        most, table_ovf, carry_ovf = _all_reduce(
            [self.size, int(self._table_ovf), int(self._carry_ovf)],
            device=self.device)
        self._max_confirmed, self._pending = most, 0
        self._table_ovf = self._carry_ovf = False
        if carry_ovf:
            raise RuntimeError(
                "sharded counter: overflow-carry buffer exceeded "
                "(adversarial bucket skew); raise overflow_buf")
        if table_ovf:
            self._grow()

    def _grow(self) -> None:
        self.tkeys, self.tcnts, self.size = _grown(self.tkeys, self.tcnts)
        self.shard_cap *= 2
        (self._max_confirmed,) = _all_reduce([self.size], device=self.device)
        self._pending = 0

    def _ensure_room(self, incoming: int) -> None:
        if (self._max_confirmed + self._pending + incoming
                <= self.shard_cap * self.max_load):
            return
        self._sync()
        while self._max_confirmed + incoming > self.shard_cap * self.max_load:
            self._grow()

    # -- steps ----------------------------------------------------------------
    def _incoming(self, rows: int, length: int) -> int:
        """JAX's growth estimate for a block of (rows, length) codes: the
        expectation of one shard's keys plus a skew margin. It tunes how
        often the ranks sync; the table flag keeps the counts exact."""
        local = rows * max(length - self.k + 1, 0) + self.overflow_buf
        return local + 4 * int(local ** 0.5) + 64

    def add_codes(self, codes) -> None:
        """One step on this rank's (rows, L) block of codes (-1 padded; numpy
        or a tensor). Every rank steps together, each with its own block of
        the same shape: JAX's (B, L) batch split over n is rows
        [r * B / n, (r + 1) * B / n) on rank r."""
        codes = torch.as_tensor(codes).to(self.device)
        rows, length = codes.shape
        incoming = self._incoming(rows, length)
        self._ensure_room(incoming)
        keys, _ = canonical_kmers(codes, self.k, self.hasher)
        self._step(keys.reshape(-1), rows * length, incoming)

    def add_ragged(self, codes: torch.Tensor, starts: torch.Tensor,
                   lens: torch.Tensor, offs: torch.Tensor, n: int) -> None:
        """One step on at most batch // n_ranks ragged rows, `n` windows in
        all (exact keys through B1's ragged entry,
        ops/extract_cuda.extract_append_ragged), sized as the
        (batch // n_ranks, max_len) block JAX would see."""
        rows = self.batch // self.n
        incoming = self._incoming(rows, self.max_len)
        self._ensure_room(incoming)
        keys = torch.empty(n, dtype=torch.int64, device=self.device)
        extract_append_ragged(codes, starts, lens, offs, self.k, keys)
        self._step(keys, rows * self.max_len, incoming)

    def add_empty(self, rows: int) -> None:
        """One step without reads (the carry alone), sized as a block of
        `rows` empty reads: a rank whose input has ended steps so."""
        incoming = self._incoming(rows, self.max_len)
        self._ensure_room(incoming)
        self._step(self.ov_keys[:0], rows * self.max_len, incoming)

    def _step(self, keys: torch.Tensor, lanes: int, incoming: int) -> None:
        """Steps 1-5 on this rank's keys (SENTINEL lanes allowed); `lanes`
        is the padded length of JAX's local key array without the carry."""
        m = self.overflow_buf
        # JAX's _weighted_unique: the carry's counts plus 1 per key lane
        ukeys, ucnts = consolidate(self.ov_keys, self.ov_cnts, keys)
        cap = -(-(lanes + m) // self.n) * self.slack
        buckets, ovk, ovc = _bucket_by_owner(ukeys, ucnts, self.n, cap)
        got = torch.empty_like(buckets)
        dist.all_to_all_single(got, buckets)
        got = got.view(-1, 2)
        rkeys, rcnts = consolidate(got[:, 0], got[:, 1], got[:0, 0])
        new, residual = _insert_unique(self.tkeys, self.tcnts, rkeys, rcnts)
        self.size += new
        self._table_ovf |= residual.numel() > 0
        ck, cc = consolidate(torch.cat([ovk, rkeys[residual]]),
                             torch.cat([ovc, rcnts[residual]]), ovk[:0])
        self._carry_ovf |= ck.numel() > m
        self.ov_keys, self.ov_cnts = ck[:m], cc[:m]
        self._pending += incoming

    def drain(self) -> None:
        """Step with empty blocks until no rank carries a key. Every pass
        shrinks the carry or grows the shards; two passes with neither raise."""
        prev_live = None
        stalls = 0
        while True:
            cap_before = self.shard_cap
            self._sync()
            (live,) = _all_reduce([self.ov_keys.numel()], dist.ReduceOp.SUM,
                                  device=self.device)
            if live == 0:
                return
            progressed = (prev_live is None or live < prev_live
                          or self.shard_cap > cap_before)
            stalls = 0 if progressed else stalls + 1
            if stalls >= 2:
                raise RuntimeError(
                    f"overflow carry failed to drain (stuck at {live} keys)")
            prev_live = live
            self.add_empty(1)

    # -- extraction -------------------------------------------------------------
    def shard_items(self) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's shard: live keys ascending, their counts (not
        clamped)."""
        live = self.tkeys != EMPTY
        keys, order = torch.sort(self.tkeys[live])
        return keys, self.tcnts[live][order]

    def items_host(self) -> tuple[np.ndarray, np.ndarray]:
        """Drain, then the whole map on every rank: key-sorted (keys,
        counts), counts clamped at 32767."""
        self.drain()
        keys, cnts = all_gather_items(*self.shard_items())
        keys, order = torch.sort(keys)
        return (keys.cpu().numpy(),
                cnts[order].clamp_max(SATURATION).to(torch.int32).cpu()
                .numpy())
