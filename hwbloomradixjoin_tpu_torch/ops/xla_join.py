"""Sort-based join count (the ``sortscan`` tier), plain PyTorch.

Counterpart of ``hwbloomradixjoin_tpu/ops/xla_join.py:32-77``: R and S rows
sort together by (key, side), R first within a key, so each S row's match
count is the number of R rows in its key segment.  Duplicate keys are allowed
on both sides.  Checksums are mod 2^32, as in the JAX package.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def sort_scan_count(r_key, r_pay, s_key, s_pay):
    """(count, sum of matched R payloads, sum of matched S payloads)."""
    return scan_sorted_count(*sort_rows(r_key, r_pay, s_key, s_pay))


def sort_rows(r_key, r_pay, s_key, s_pay):
    """The clustering half of sort_scan_count: (key, tag, pay) of R and S
    rows sorted by (key, tag), tag 0 for R and 1 for S."""
    key = torch.cat([r_key, s_key])
    tag = torch.cat([torch.zeros_like(r_key), torch.ones_like(s_key)])
    pay = torch.cat([r_pay, s_pay])
    order = torch.sort(key.long() * 2 + tag.long(), stable=True).indices
    return key[order], tag[order], pay[order]


def scan_sorted_count(key, tag, pay):
    """The probe half of sort_scan_count: segmented scan over sorted rows."""
    n = key.shape[0]
    is_r = tag == 0
    boundary = torch.ones(n, dtype=torch.bool, device=key.device)
    boundary[1:] = key[1:] != key[:-1]
    idx = torch.arange(n, device=key.device)
    seg_start = torch.cummax(torch.where(boundary, idx, -1), dim=0).values

    r_flag = is_r.long()
    r_pref = torch.cumsum(r_flag, 0) - r_flag
    rp_val = torch.where(is_r, pay.long() & MASK32, 0)
    rp_pref = torch.cumsum(rp_val, 0) - rp_val

    r_in_seg = r_pref - r_pref[seg_start]
    rp_in_seg = rp_pref - rp_pref[seg_start]
    s_rows = ~is_r
    count = torch.where(s_rows, r_in_seg, 0).sum()
    sum_rpay = (torch.where(s_rows, rp_in_seg, 0) & MASK32).sum() & MASK32
    sum_spay = ((torch.where(s_rows, pay.long() & MASK32, 0)
                 * (r_in_seg & MASK32)) & MASK32).sum() & MASK32
    return count, sum_rpay, sum_spay
