"""Perfect-addressed count-table join (the ``ht`` tier), plain PyTorch.

Counterpart of ``hwbloomradixjoin_tpu/ops/ht_join.py``: the build
scatters a multiplicity table (and a payload-sum table mod 2^32) over R's key
range [lo, hi]; the probe gathers one slot per S key.  Exact for any key
multiset.  Sums are taken in int64 and reduced mod 2^32, the JAX package's
uint32 wraparound.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def build_tables(r_key: torch.Tensor, r_pay: torch.Tensor, lo: int, hi: int,
                 with_paysum: bool = True):
    """Build phase: multiplicity table (+ payload-sum table mod 2^32)."""
    nslots = hi - lo + 1
    ok = (r_key >= lo) & (r_key <= hi)
    idx = r_key[ok].long() - lo
    cnt_tbl = torch.zeros(nslots, dtype=torch.int64, device=r_key.device)
    cnt_tbl.index_add_(0, idx, torch.ones_like(idx))
    if not with_paysum:
        return cnt_tbl, cnt_tbl.new_zeros(0)
    pay_tbl = torch.zeros(nslots, dtype=torch.int64, device=r_key.device)
    pay_tbl.index_add_(0, idx, r_pay[ok].long() & MASK32)
    return cnt_tbl, pay_tbl & MASK32


def probe_tables(cnt_tbl: torch.Tensor, pay_tbl: torch.Tensor,
                 s_key: torch.Tensor, s_pay: torch.Tensor, lo: int, hi: int):
    """Probe phase: (count, sum of matched R payloads, sum of S payload *
    multiplicity), the sums mod 2^32; each a 0-d int64 tensor."""
    ok = (s_key >= lo) & (s_key <= hi)
    idx = torch.where(ok, s_key.long() - lo, 0)
    mult = torch.where(ok, cnt_tbl[idx], 0)
    count = mult.sum()
    if pay_tbl.numel():
        sum_rpay = torch.where(ok, pay_tbl[idx], 0).sum() & MASK32
    else:
        sum_rpay = torch.zeros((), dtype=torch.int64, device=s_key.device)
    sum_spay = ((s_pay.long() & MASK32) * mult & MASK32).sum() & MASK32
    return count, sum_rpay, sum_spay


def counttable_join_count(r_key: torch.Tensor, r_pay: torch.Tensor,
                          s_key: torch.Tensor, s_pay: torch.Tensor,
                          lo: int, hi: int, with_checksums: bool = True):
    """Join count and checksums through a count table over R's declared key
    range [lo, hi] (JAX ht_join.py:68): (count, sum_rpay, sum_spay) as
    sort_scan_count gives them; sum_rpay is 0 without checksums.  S keys
    outside the range cannot match; R keys outside it would be dropped, so
    callers pass the true range.  PAD slots on either side fall outside it.
    """
    cnt_tbl, pay_tbl = build_tables(r_key, r_pay, lo, hi,
                                    with_paysum=with_checksums)
    return probe_tables(cnt_tbl, pay_tbl, s_key, s_pay, lo, hi)


def counttable_probe_mask(r_key: torch.Tensor, s_key: torch.Tensor, lo: int,
                          hi: int) -> torch.Tensor:
    """Exact membership of each S key in R's keys within [lo, hi]: bool
    (JAX ht_join.py:84)."""
    present = torch.zeros(hi - lo + 1, dtype=torch.bool, device=r_key.device)
    ok = (r_key >= lo) & (r_key <= hi)
    present[r_key[ok].long() - lo] = True
    s_ok = (s_key >= lo) & (s_key <= hi)
    return s_ok & present[torch.where(s_ok, s_key.long() - lo, 0)]
