"""Hash aggregate (group-by) operator, plain PyTorch.

Counterpart of ``hwbloomradixjoin_tpu/ops/aggregate.py``.  The reference
implies this operator through its analysis workloads (the BASELINE Zipf
configuration runs a hash aggregate over the join output).  A group-by is a
sort and a segmented reduction, the sort-scan core of the ``sortscan`` join
(``ops/xla_join.py``).  The JAX docstring's "Pallas tier" was never written,
so there is no kernel here.

Outputs have capacity |keys|: unique keys with per-group count and sum
columns, padded with PAD_KEY / 0, and the number of groups.  uint32 sums
are int64 tensors holding values in [0, 2^32).
"""

from __future__ import annotations

import torch

from hwbloomradixjoin_tpu_torch.ops.xla_join import MASK32, segment_starts
from hwbloomradixjoin_tpu_torch.types import PAD_KEY


def _kept_first(keep: torch.Tensor) -> torch.Tensor:
    """The permutation that moves the rows where keep holds to the front,
    each part in its input order (the JAX package's sort by position, with
    the kept rows' positions first)."""
    return torch.cat([keep.nonzero().squeeze(1), (~keep).nonzero().squeeze(1)])


def group_by_key(keys: torch.Tensor, values: torch.Tensor | None = None):
    """Group rows by key: (unique_keys, counts, sums, num_groups).

    Unique keys ascend; entries past num_groups hold PAD_KEY / 0.  counts
    are int32; sums the uint32 wraparound sum of each group's values (0s if
    values is None), as int64; num_groups a 0-d int32 tensor.  The segment
    starts come from xla_join.segment_starts, where the JAX package takes a
    cummax (aggregate.py:34).
    """
    n = keys.shape[0]
    if values is None:
        values = torch.zeros_like(keys)
    order = torch.sort(keys, stable=True).indices
    k_s = keys[order]
    v_s = values[order].long() & MASK32
    seg_start = segment_starts(k_s)

    idx = torch.arange(n, device=keys.device)
    val_pref = torch.cumsum(v_s, 0) - v_s
    is_last = torch.ones(n, dtype=torch.bool, device=keys.device)
    torch.ne(k_s[1:], k_s[:-1], out=is_last[:-1])
    seg_cnt = (idx + 1 - seg_start).int()
    seg_sum = (val_pref + v_s - val_pref[seg_start]) & MASK32

    perm = _kept_first(is_last)
    num_groups = is_last.sum().int()
    pad = idx >= num_groups
    return (torch.where(pad, PAD_KEY, k_s[perm]),
            torch.where(pad, 0, seg_cnt[perm]),
            torch.where(pad, 0, seg_sum[perm]), num_groups)


def join_group_count(r_key: torch.Tensor, s_key: torch.Tensor):
    """Aggregate over the join output without materializing it.

    For each key present on both sides, the joined group's size is its R
    multiplicity times its S multiplicity (an int32 product, as in the JAX
    package).  Returns (keys, group_counts, num_groups) of capacity |R|
    (distinct join keys cannot outnumber distinct R keys): the joined keys
    ascending, then, as in the JAX package, the keys of the grouped rows
    that did not join, in their sorted order, with count 0.
    """
    rk_u, rc, _, _ = group_by_key(r_key)
    sk_u, sc, _, _ = group_by_key(s_key)
    # match the two grouped tables (both unique) by sorting them together
    # by (key, side), R first
    key = torch.cat([rk_u, sk_u])
    side = torch.cat([torch.zeros_like(rc), torch.ones_like(sc)])
    cnt = torch.cat([rc, sc])
    order = torch.sort(key.long() * 2 + side.long(), stable=True).indices
    key, side, cnt = key[order], side[order], cnt[order]
    # adjacent (R, S) rows of one key are a joined group; the PAD rows of
    # both tables are not
    match = (key[:-1] == key[1:]) & (side[:-1] == 0) & (side[1:] == 1) \
        & (key[:-1] != PAD_KEY)
    perm = _kept_first(match)[:r_key.shape[0]]
    out_cnt = torch.where(match, cnt[:-1] * cnt[1:], 0)
    return key[:-1][perm], out_cnt[perm], match.sum().int()
