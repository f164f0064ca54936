"""The plain reference: the answers of a query worked out again from the
benchmark's own inputs, in plain torch.

An equi-join of R and S on their keys:

- ``count``: the number of (r, s) pairs with equal keys;
- ``r_sum`` / ``s_sum``: the sum over those pairs of R's payload, and of
  S's payload, each mod 2^32 (the reference suite's checksums);
- ``s_after``: the S tuples that the configuration's bloom filter over R's
  keys contains (hashes from ``filterhash.py``).

It sorts R's keys once and looks every S key up by binary search, block by
block, so it fits beside the relations on the device.  ``keys_of`` lets the
control put a lower precision of the keys in their place.
"""

from __future__ import annotations

import torch

from joinbench import filterhash

MASK32 = 0xFFFFFFFF
BLOCK = 1 << 26


def _exact(keys: torch.Tensor) -> torch.Tensor:
    return keys.long()


def join(r_key, r_pay, s_key, s_pay, keys_of=_exact) -> dict:
    """count, r_sum and s_sum of R join S."""
    rk, order = torch.sort(keys_of(r_key))
    cum = torch.zeros(rk.numel() + 1, dtype=torch.int64, device=rk.device)
    torch.cumsum(r_pay.long()[order] & MASK32, 0, out=cum[1:])
    del order
    count = r_sum = s_sum = 0
    for b0 in range(0, s_key.numel(), BLOCK):
        sk = keys_of(s_key[b0:b0 + BLOCK])
        lo = torch.searchsorted(rk, sk)
        hi = torch.searchsorted(rk, sk, right=True)
        n = hi - lo
        count += int(n.sum())
        r_sum += int(((cum[hi] - cum[lo]) & MASK32).sum())
        s_sum += int((((s_pay[b0:b0 + BLOCK].long() & MASK32) * n)
                      & MASK32).sum())
    return {"count": count, "r_sum": r_sum & MASK32, "s_sum": s_sum & MASK32}


def survivors(r_key, s_key, filt: dict, keys_of=_exact) -> int:
    """S tuples that the filter of R's keys contains."""
    bits = torch.zeros(filt["m"], dtype=torch.bool, device=r_key.device)
    for b0 in range(0, r_key.numel(), BLOCK):
        for pos in filterhash.positions(keys_of(r_key[b0:b0 + BLOCK]), filt):
            bits[pos] = True
    kept = 0
    for b0 in range(0, s_key.numel(), BLOCK):
        hit = None
        for pos in filterhash.positions(keys_of(s_key[b0:b0 + BLOCK]), filt):
            hit = bits[pos] if hit is None else hit & bits[pos]
        kept += int(hit.sum())
    return kept


def answers(rel, config: dict, traffic: dict, keys_of=_exact) -> dict:
    """The numbers a query of `traffic` over `rel` has to give."""
    out = join(rel.r_key, rel.r_pay, rel.s_key, rel.s_pay, keys_of)
    if traffic["result"] == "count":
        out = {"count": out["count"]}
    if traffic["filter"]:
        out["s_after"] = survivors(rel.r_key, rel.s_key, config["filter"],
                                   keys_of)
    return out


# The configurations state an exact join, so every number compared has the
# limit 0: a count, a checksum or a survivor count is right or wrong.
LIMITS = {"count": 0, "r_sum": 0, "s_sum": 0, "s_after": 0}


def gap(name: str, got: int, want: int) -> int:
    """How far `got` lies from `want`: the checksums as distances mod 2^32."""
    if name in ("r_sum", "s_sum"):
        d = (got - want) % (1 << 32)
        return min(d, (1 << 32) - d)
    return abs(got - want)


def compare(results: list[dict], want: dict) -> tuple[dict, int]:
    """({name: widest gap over the queries}, queries with a gap past its
    limit) for the program's `results` against the reference's `want`."""
    widest = {name: 0 for name in want}
    failed = 0
    for got in results:
        bad = False
        for name, value in want.items():
            g = gap(name, got[name], value)
            widest[name] = max(widest[name], g)
            bad |= g > LIMITS[name]
        failed += bad
    return widest, failed
