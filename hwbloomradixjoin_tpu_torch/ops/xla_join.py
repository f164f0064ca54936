"""Sort-based joins (the ``sortscan`` and ``materialize`` tiers), plain
PyTorch.

Counterpart of ``hwbloomradixjoin_tpu/ops/xla_join.py:32-118, 121-160,
209-392``: R and S rows sort together by (key, side), R first within a key,
so each S row's match count is the number of R rows in its key segment.
Duplicate keys are allowed on both sides.  Checksums are mod 2^32, as in
the JAX package, and mod 2^64 for KEY_8B's 64-bit payloads (the ``_wide``
functions, the ``key8b`` and ``materialize8b`` tiers).  The materializing
forms emit the matched (R payload, S payload, key) rows; on the card they
are the independent oracle of the materialization kernel.
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


def segment_starts(key):
    """The index of the first row of each sorted row's key segment.

    A scan of the segment boundaries and a gather: torch.cummax runs a
    one-row scan on one CUDA block (~3.4 ns a row on an H100, where this
    takes a device-wide cumsum).
    """
    boundary = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    torch.ne(key[1:], key[:-1], out=boundary[1:])
    first = boundary.nonzero().squeeze(1)
    return first[torch.cumsum(boundary, 0) - 1]


def scan_sorted_count(key, tag, pay):
    """The probe half of sort_scan_count: segmented scan over sorted rows."""
    is_r = tag == 0
    seg_start = segment_starts(key)

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


def _segments(key, tag):
    """(is_r, seg_start, inclusive R prefix) of rows sorted by (key, tag)."""
    is_r = tag == 0
    return is_r, segment_starts(key), torch.cumsum(is_r.long(), 0)


def sort_scan_materialize(r_key, r_pay, s_key, s_pay):
    """Materialized join for a unique-key build side.

    Returns (count, r_payload_out, s_payload_out, key_out): |S|-row int32
    columns whose first count rows hold the matched pairs in (key, S order)
    order, the rest 0, 0 and PAD, array for array the JAX package's
    sort_scan_materialize (xla_join.py:79).
    """
    ns = s_key.shape[0]
    key, tag, pay = sort_rows(r_key, r_pay, s_key, s_pay)
    is_r, seg_start, r_pref = _segments(key, tag)
    # the R row of a key sorts first; an S row matches when its segment's
    # exclusive R count is exactly 1
    r_in_seg = (r_pref - is_r.long()) - (r_pref - is_r.long())[seg_start]
    matched = (~is_r) & (r_in_seg == 1)
    rows = matched.nonzero().squeeze(1)
    count = rows.numel()
    out_r = torch.zeros(ns, dtype=torch.int32, device=key.device)
    out_s = torch.zeros_like(out_r)
    out_k = torch.full_like(out_r, -2**31)
    out_r[:count] = pay[seg_start[rows]]
    out_s[:count] = pay[rows]
    out_k[:count] = key[rows]
    return torch.tensor(count, device=key.device), out_r, out_s, out_k


def sort_scan_materialize_multi(r_key, r_pay, s_key, s_pay, out_cap: int):
    """Materialized join for a non-unique build side: all (R, S) pairs.

    Each S row whose key appears m times in R emits m pairs.  out_cap is
    the output capacity (callers pre-count with sort_scan_count); rows past
    the total carry PAD in all three columns.  Returns (count,
    r_payload_out, s_payload_out, key_out), array for array the JAX
    package's sort_scan_materialize_multi (xla_join.py:282).
    """
    return _all_pairs(*sort_rows(r_key, r_pay, s_key, s_pay), out_cap,
                      -2**31)


def _all_pairs(key, tag, pay, out_cap: int, pad: int):
    """Every (R, S) pair of rows sorted by (key, tag), R rows first in each
    key segment: (count, R payloads, S payloads, keys) of out_cap rows, the
    pairs in (key, S order, R order) order, the rest `pad`."""
    n = key.shape[0]
    is_r, seg_start, r_pref = _segments(key, tag)
    # R rows sort before every S row of their key, so at an S row r_pref
    # already counts the segment's whole R run
    before = torch.where(seg_start > 0,
                         r_pref[torch.clamp(seg_start - 1, min=0)], 0)
    m = torch.where(~is_r, r_pref - before, 0)
    csum = torch.cumsum(m, 0)
    total = csum[-1]
    j = torch.arange(out_cap, device=key.device)
    i = torch.clamp(torch.searchsorted(csum, j, right=True), max=n - 1)
    src_r = torch.clamp(seg_start[i] + j - (csum - m)[i], max=n - 1)
    valid = j < total
    pad = torch.tensor(pad, dtype=key.dtype, device=key.device)
    return (total, torch.where(valid, pay[src_r], pad),
            torch.where(valid, pay[i], pad), torch.where(valid, key[i], pad))


def hash_multiplicative(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Cheap bucket hash: the top `bits` bits of the uint32 Knuth product
    key * 2654435761 (JAX xla_join.py:160), int32.  The product and the
    logical shift are taken in int64: torch's >> on int32 is arithmetic."""
    h = ((keys.long() & MASK32) * 2654435761) & MASK32
    return (h >> (32 - bits)).to(torch.int32)


def csr_hash_join_count(r_key, r_pay, s_key, s_pay, bits: int | None = None,
                        max_bucket: int = 8):
    """NPO-shaped join: a CSR-bucketized R table and a windowed probe
    (JAX xla_join.py:166).

    bits: log2 of the bucket count; by default ~2 tuples a bucket, the
    reference's BUCKET_SIZE = 2 (npj_params.h:18).  max_bucket: the probe
    window; overflow (a 0-d bool) is True when a bucket holds more R
    tuples, and the matches past the window are then not counted.  Returns
    (count, sum of matched R payloads, sum of matched S payloads, overflow),
    the sums mod 2^32.
    """
    nr = r_key.shape[0]
    if bits is None:
        bits = max((max(nr // 2, 1) - 1).bit_length(), 1)
    rb = hash_multiplicative(r_key, bits)
    order = torch.sort(rb, stable=True).indices
    rk_s, rp_s = r_key[order], r_pay[order].long() & MASK32
    offsets = torch.searchsorted(
        rb[order], torch.arange((1 << bits) + 1, dtype=torch.int32,
                                device=r_key.device))
    counts = offsets[1:] - offsets[:-1]
    overflow = counts.max() > max_bucket

    sb = hash_multiplicative(s_key, bits).long()
    start, scount = offsets[sb], counts[sb]
    sp = s_pay.long() & MASK32
    cnt = sum_rp = sum_sp = torch.zeros((), dtype=torch.int64,
                                        device=s_key.device)
    for j in range(max_bucket):
        idx = torch.clamp(start + j, max=nr - 1)
        hit = (j < scount) & (rk_s[idx] == s_key)
        cnt = cnt + hit.sum()
        sum_rp = sum_rp + torch.where(hit, rp_s[idx], 0).sum()
        sum_sp = sum_sp + torch.where(hit, sp, 0).sum()
    return cnt, sum_rp & MASK32, sum_sp & MASK32, overflow


# KEY_8B: 64-bit keys and payloads ride as (hi, lo) int32 columns, as in the
# JAX package (xla_join.py:121-392).  One int64 column (hi << 32) | (lo as
# unsigned) sorts in the JAX package's (hi signed, lo unsigned) order, and
# int64 arithmetic wraps mod 2^64, so 64-bit checksums are plain int64 sums.

# The (PAD, PAD) key pair as one int64: the key of an unmatched output row.
PAD_PAIR = (-2**31 << 32) | 2**31


def wide(hi, lo):
    """(hi, lo) int32 columns -> int64 values (lo taken as unsigned)."""
    return (hi.long() << 32) | (lo.long() & MASK32)


def sort_rows_wide(r_key, s_key, r_pay, s_pay):
    """(key, tag, pay) of R and S rows sorted by their int64 keys, tag 0 for
    R: R's rows come first in the concatenation and the sort is stable, so
    R rows lead each key segment, as the JAX package's sort by (hi, lo,
    tag) orders them."""
    key, order = torch.sort(torch.cat([r_key, s_key]), stable=True)
    tag = (order >= r_key.numel()).to(torch.int32)
    pay = torch.cat([r_pay, s_pay])[order]
    return key, tag, pay


def sort_scan_count_wide(r_hi, r_lo, r_pay, s_hi, s_lo, s_pay):
    """sort_scan_count over 64-bit keys carried as (hi, lo) int32 columns,
    int32 payloads: (count, R checksum, S checksum), the sums mod 2^32
    (JAX xla_join.py:121)."""
    return scan_sorted_count(*sort_rows_wide(wide(r_hi, r_lo),
                                             wide(s_hi, s_lo), r_pay, s_pay))


def _wide_segments(key, tag):
    """(S-row mask, seg_start, R rows in each row's segment before it) of
    rows sorted by sort_rows_wide."""
    seg_start = segment_starts(key)
    r_flag = (tag == 0).long()
    r_pref = torch.cumsum(r_flag, 0) - r_flag
    del r_flag
    return tag == 1, seg_start, r_pref - r_pref[seg_start]


def sort_scan_count_wide64(r_khi, r_klo, r_phi, r_plo,
                           s_khi, s_klo, s_phi, s_plo):
    """64-bit keys and 64-bit payloads: (count, R checksum, S checksum), the
    sums int64 tensors whose bits are the JAX package's (hi, lo) sums mod
    2^64 (xla_join.py:230)."""
    key, tag, pay = sort_rows_wide(wide(r_khi, r_klo), wide(s_khi, s_klo),
                                   wide(r_phi, r_plo), wide(s_phi, s_plo))
    s_rows, seg_start, r_in_seg = _wide_segments(key, tag)
    del key, tag
    rp = torch.where(s_rows, 0, pay)
    rp_pref = torch.cumsum(rp, 0) - rp
    del rp
    d = rp_pref - rp_pref[seg_start]
    del rp_pref, seg_start
    count = torch.where(s_rows, r_in_seg, 0).sum()
    sum_r = torch.where(s_rows, d, 0).sum()
    sum_s = torch.where(s_rows, pay * r_in_seg, 0).sum()
    return count, sum_r, sum_s


def sort_scan_materialize_wide(r_khi, r_klo, r_phi, r_plo,
                               s_khi, s_klo, s_phi, s_plo):
    """Materialized KEY_8B join: (count, R payloads, S payloads, keys), |S|
    int64 rows whose first count hold the matched pairs in (key, S order)
    order, the rest 0, 0 and PAD_PAIR (JAX xla_join.py:331, its (hi, lo)
    pairs as int64).

    Like the JAX function, an S row matches only when its key segment holds
    exactly one R row: for a key that repeats in R it emits no pair, where
    the reference emits one pair a copy.  Callers pass a unique R, and
    sort_scan_materialize_wide_multi serves any other.
    """
    ns = s_klo.shape[0]
    key, tag, pay = sort_rows_wide(wide(r_khi, r_klo), wide(s_khi, s_klo),
                                   wide(r_phi, r_plo), wide(s_phi, s_plo))
    s_rows, seg_start, r_in_seg = _wide_segments(key, tag)
    rows = (s_rows & (r_in_seg == 1)).nonzero().squeeze(1)
    count = rows.numel()
    out_r = torch.zeros(ns, dtype=torch.int64, device=key.device)
    out_s = torch.zeros_like(out_r)
    out_k = torch.full_like(out_r, PAD_PAIR)
    out_r[:count] = pay[seg_start[rows]]
    out_s[:count] = pay[rows]
    out_k[:count] = key[rows]
    return torch.tensor(count, device=key.device), out_r, out_s, out_k


def sort_scan_materialize_wide_multi(r_khi, r_klo, r_phi, r_plo,
                                     s_khi, s_klo, s_phi, s_plo,
                                     out_cap: int):
    """Materialized KEY_8B join for any R: every (R, S) pair, one a copy of
    each R key, as the reference emits them (parallel_radix_join.c:255-330).

    sort_scan_materialize_multi over the int64 key column of
    sort_rows_wide, payloads as int64: (count, R payloads, S payloads,
    keys), out_cap int64 rows (callers pre-count with
    sort_scan_count_wide), rows past the count PAD_PAIR in all three.
    """
    return _all_pairs(*sort_rows_wide(wide(r_khi, r_klo), wide(s_khi, s_klo),
                                      wide(r_phi, r_plo), wide(s_phi, s_plo)),
                      out_cap, PAD_PAIR)
