"""Distributed join count over a torch.distributed process group.

Counterpart of ``hwbloomradixjoin_tpu/parallel/dist_join.py``.  The
reference's shared-memory "collectives" map onto real ones:

    thread fan-out + barriers    -> one process a device, the same steps
    global histogram prefix-sums -> all_reduce of per-device histograms
    shared scatter array         -> all_to_all_single partition shuffle
    result sum (join_init_run)   -> all_reduce of per-device results
    NUMA-local task queues       -> static hash ownership: device d owns
                                    the d-th range of the keys' hash

Bloom pre-filtering happens before the shuffle (the distributed analogue of
the reference pruning S during pass 1, parallel_radix_join_bloom.c:798-849):
each device builds the filter of its R shard, the filters are OR-combined
across devices, and S tuples that fail it are dropped before any byte
moves.  As in the JAX package the filter is plain tensor code
(``ops/bloom.py``), not the prune kernel.

Send buffers have a fixed capacity, (D, cap) filled with PAD_KEY, so every
device sends and receives the same sizes; ``overflow`` counts the tuples
dropped past cap, and callers re-run with a larger pad factor or with skew
handling (``skew.py``).  On one device whose buffers would hold every
tuple, nothing is packed or moved: the sort-scan takes the valid rows as
they are.  The local join is the sort-scan
(``ops/xla_join.sort_scan_count``, with checksums) or the bitmap engine
(``ops/bitmap_join.traced_radix_count``: kernels 1, 3 and 4 on the card,
count only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hwbloomradixjoin_tpu_torch.config import BloomArgs
from hwbloomradixjoin_tpu_torch.ops import bitmap_join, bloom, xla_join
from hwbloomradixjoin_tpu_torch.ops.xla_join import MASK32
from hwbloomradixjoin_tpu_torch.parallel import skew
from hwbloomradixjoin_tpu_torch.types import PAD_KEY

ENGINES = ("sortscan", "pallas")


def _dest_of(keys: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Destination device: the top log2(D) bits of the multiplicative hash,
    capped at D - 1 for a D that is not a power of two."""
    if n_dev == 1:
        return torch.zeros_like(keys)
    h = xla_join.hash_multiplicative(keys, (n_dev - 1).bit_length())
    return torch.clamp(h, max=n_dev - 1)


def _pack_by_dest(dest: torch.Tensor, valid: torch.Tensor, cap: int,
                  n_dev: int, *cols: torch.Tensor):
    """Group the valid rows of cols by destination into (D, cap) buffers
    filled with PAD_KEY: ([buffer of each column], overflow).

    Deterministic: a stable sort by destination (invalid rows sort last and
    are dropped, they carry no data); valid rows ranked at cap or past it
    within their destination are dropped and counted in overflow (a 0-d
    int64 tensor).
    """
    sort_key = torch.where(valid, dest, n_dev)
    order = torch.sort(sort_key, stable=True).indices
    d_s = sort_key[order]
    pos = torch.arange(d_s.numel(), device=d_s.device) \
        - xla_join.segment_starts(d_s)
    real = d_s < n_dev
    keep = real & (pos < cap)
    overflow = (real & (pos >= cap)).sum()
    # rows not kept land in one slot past the buffers, dropped below
    slot = torch.where(keep, d_s.long() * cap + pos, n_dev * cap)
    outs = []
    for c in cols:
        buf = torch.full((n_dev * cap + 1,), PAD_KEY, dtype=c.dtype,
                         device=c.device)
        buf[slot] = c[order]
        outs.append(buf[:-1].view(n_dev, cap))
    return outs, overflow


def _all_to_all(buf: torch.Tensor, group) -> torch.Tensor:
    """Row j of the (D, cap) buffer goes to rank j; row i of the result
    came from rank i (the JAX package's all_to_all, tiled=False), flat."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.view(-1)


def _all_gather(x: torch.Tensor, n_dev: int, group) -> torch.Tensor:
    """Every rank's x, in rank order, concatenated."""
    parts = [torch.empty_like(x) for _ in range(n_dev)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _or_across_devices(words: torch.Tensor, n_dev: int, group):
    """Bitwise OR of every rank's filter words, shard by shard.

    An all_gather of whole filters would move D * m bits to every device
    and hold them at once.  Instead the words are cut into D shards; rank d
    receives every rank's shard d (all_to_all), ORs them, and the reduced
    shards are all_gathered: ~2m bits in and out a device, whatever D (the
    reference ORs into one shared bitmap with atomic fetch-or,
    bloom_filter.c:84).
    """
    if n_dev == 1:
        return words
    n = words.numel()
    pad = (-n) % n_dev
    if pad:
        words = torch.cat([words, words.new_zeros(pad)])
    recv = _all_to_all(words.view(n_dev, -1), group).view(n_dev, -1)
    mine = recv[0].clone()
    for row in recv[1:]:
        mine |= row
    return _all_gather(mine, n_dev, group)[:n]


def _all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks of a scalar, as a new 0-d int64."""
    x = x.to(torch.int64, copy=True).reshape(())
    dist.all_reduce(x, group=group)
    return x


@dataclasses.dataclass
class DistJoin:
    """A distributed join placed on one rank: its contiguous 1/D block of
    each column on its device, the buffer capacity and the engine.  run()
    is the timed part: it moves only what the join itself moves."""

    group: object
    n_dev: int
    rank: int
    rk: torch.Tensor
    rp: torch.Tensor
    sk: torch.Tensor
    sp: torch.Tensor
    cap: int
    bloom_args: Optional[BloomArgs]
    skew_handling: bool
    local_engine: str
    key_lo: int
    key_hi: int

    def run(self):
        """(count, R checksum, S checksum, S tuples after the filter,
        overflow), 0-d int64 tensors, the same on every rank of the group.
        The checksums are mod 2^32 (0 for the pallas engine); S-after is -1
        without a filter; overflow counts the tuples the buffers' capacity
        dropped, and when it is > 0 the count is not valid.  The pallas
        engine's kernels count runs of any length exactly, so JAX's window
        flag (bitmap_join.traced_radix_count) is not part of it.
        """
        g, D = self.group, self.n_dev
        rk, rp, sk, sp = self.rk, self.rp, self.sk, self.sp
        dev = rk.device
        s_after = torch.full((), -1, dtype=torch.int64, device=dev)
        if self.bloom_args is not None:
            words = _or_across_devices(bloom.build_bitmap(rk, self.bloom_args),
                                       D, g)
            # padding slots (PAD keys) do not count as survivors
            mask = bloom.probe_bitmap(words, sk, self.bloom_args) \
                & (sk != PAD_KEY)
            sk = torch.where(mask, sk, PAD_KEY)
            s_after = _all_sum(mask.sum(), g)

        rd, sd = _dest_of(rk, D), _dest_of(sk, D)
        r_valid, s_valid = rk != PAD_KEY, sk != PAD_KEY
        heavy_cnt = torch.zeros((), dtype=torch.int64, device=dev)
        r_heavy_rows = None
        if self.skew_handling and D > 1:
            heavy = skew.heavy_dest_mask(sd, D, g, valid=s_valid)
            salt = torch.arange(sk.numel(), device=dev) + self.rank
            sd = skew.split_heavy_dests(sd, heavy, D, salt)
            # R tuples bound for a heavy destination go to every device (a
            # broadcast join for the hot hash range), not to their owner
            r_heavy = skew.replicate_mask_for_r(rd, heavy)
            (rk_h, rp_h), h_ovf = _pack_by_dest(
                torch.zeros_like(rd), r_valid & r_heavy, self.cap, 1, rk, rp)
            r_heavy_rows = (_all_gather(rk_h[0], D, g),
                            _all_gather(rp_h[0], D, g))
            r_valid = r_valid & ~r_heavy
            heavy_cnt = _all_sum(h_ovf, g)

        if self.local_engine == "pallas" and D == 1:
            # one device: the local join is the join, nothing to shuffle
            rk_x, rp_x = torch.where(r_valid, rk, PAD_KEY), rp
            sk_x = torch.where(s_valid, sk, PAD_KEY)
            ovf = torch.zeros((), dtype=torch.int64, device=dev)
        elif D == 1 and self.cap >= max(rk.numel(), sk.numel()):
            # one device whose buffers hold every tuple: packing would only
            # drop the PAD rows and pad to cap, so drop them and skip it
            rk_x, rp_x = rk[r_valid], rp[r_valid]
            sk_x, sp_x = sk[s_valid], sp[s_valid]
            ovf = torch.zeros((), dtype=torch.int64, device=dev)
        else:
            # PAD tuples (pruned, or padding) are dropped at packing: the
            # point of pruning before the shuffle is that they cross no wire
            (rk_b, rp_b), r_ovf = _pack_by_dest(rd, r_valid, self.cap, D,
                                                rk, rp)
            (sk_b, sp_b), s_ovf = _pack_by_dest(sd, s_valid, self.cap, D,
                                                sk, sp)
            rk_x, rp_x = _all_to_all(rk_b, g), _all_to_all(rp_b, g)
            sk_x, sp_x = _all_to_all(sk_b, g), _all_to_all(sp_b, g)
            ovf = r_ovf + s_ovf
        if r_heavy_rows is not None:
            rk_x = torch.cat([rk_x, r_heavy_rows[0]])
            rp_x = torch.cat([rp_x, r_heavy_rows[1]])

        if self.local_engine == "pallas":
            cnt, _ = bitmap_join.traced_radix_count(
                rk_x, sk_x, self.key_lo, self.key_hi)
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            return (_all_sum(cnt, g), zero, zero, s_after,
                    _all_sum(ovf, g) + heavy_cnt)

        # R's PAD rows must not join S's: retag S's to a second sentinel
        sk_x = torch.where(sk_x == PAD_KEY, PAD_KEY + 1, sk_x)
        cnt, sr, ss = xla_join.sort_scan_count(rk_x, rp_x, sk_x, sp_x)
        return (_all_sum(cnt, g), _all_sum(sr, g) & MASK32,
                _all_sum(ss, g) & MASK32, s_after,
                _all_sum(ovf, g) + heavy_cnt)


def plan_dist_join(group, rk, rp, sk, sp,
                   bloom_args: Optional[BloomArgs] = None,
                   pad_factor: float = 2.0, skew_handling: bool = False,
                   local_engine: str = "sortscan", key_range=None,
                   device="cuda") -> DistJoin:
    """Place a distributed join on this rank of `group`.

    rk, rp, sk, sp: the full int32 columns (numpy arrays or tensors), the
    same on every rank, each length a multiple of the group's size; this
    rank keeps its contiguous 1/D block of each, on `device` (the card
    unless the caller asks for the CPU): the JAX package's P(AXIS) split.
    The capacity of each (destination, rank) buffer is int(max(|R|, |S|)
    / D / D * pad_factor) + 16.  local_engine "pallas" needs unique R keys
    in key_range (default: R's min and max).
    """
    if local_engine not in ENGINES:
        raise ValueError(f"local_engine {local_engine!r} not in {ENGINES}")
    n_dev = dist.get_world_size(group)
    rank = dist.get_rank(group)
    cols = []
    for a in (rk, rp, sk, sp):
        if a.shape[0] % n_dev:
            raise ValueError(f"{a.shape[0]} rows do not split over {n_dev} "
                             "devices")
        n = a.shape[0] // n_dev
        block = a[rank * n:(rank + 1) * n]
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(np.ascontiguousarray(block,
                                                          dtype=np.int32))
        cols.append(block.to(device=device, dtype=torch.int32).contiguous())
    n_loc, ns_loc = rk.shape[0] // n_dev, sk.shape[0] // n_dev
    cap = int(max(n_loc, ns_loc) / n_dev * pad_factor) + 16
    if local_engine == "pallas" and key_range is None:
        key_range = (int(rk.min()), int(rk.max()))
    key_lo, key_hi = key_range if key_range is not None else (0, 0)
    return DistJoin(group, n_dev, rank, *cols, cap=cap,
                    bloom_args=bloom_args, skew_handling=skew_handling,
                    local_engine=local_engine, key_lo=key_lo, key_hi=key_hi)


def dist_join_count(group, rk, rp, sk, sp,
                    bloom_args: Optional[BloomArgs] = None,
                    pad_factor: float = 2.0, skew_handling: bool = False,
                    local_engine: str = "sortscan", key_range=None,
                    device="cuda"):
    """Distributed join count over `group`: plan_dist_join, then run().

    Returns (count, sum_rpay, sum_spay, s_after_filter, overflow), as the
    JAX package's dist_join_count.  To time the join alone, plan once and
    time run().
    """
    return plan_dist_join(group, rk, rp, sk, sp, bloom_args, pad_factor,
                          skew_handling, local_engine, key_range,
                          device).run()
