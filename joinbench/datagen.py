"""The relations of a configuration, made on the device from a seed.

The key multiset is the reference suite's parallel threshold generator
(``generator.c:161-221, 304-415`` of mchashjoins): the tuples are split
into per-thread runs of whole pages; each run holds keys that cycle
upward from its first key through [1, threshold] (the matching share, q of
the run) and keys that cycle through (threshold, INT_MAX] (the rest).  A
unique primary key over [1, n] is the case threshold = maxid = n, q = 1.
The keys are then put in the order of a permutation drawn from a
``torch.Generator`` on the relation's device, seeded by the run's seed, and
each payload is its row number (the reference shuffles keys only).

Everything is computed on the device in a few large calls: the arithmetic
of the cycles block by block, one ``randperm`` and one gather a relation.
"""

from __future__ import annotations

import dataclasses

import torch

INT_MAX = 2**31 - 1
PAGE_SIZE = 4096
BLOCK = 1 << 26            # keys computed at once: 512 MiB of int64


@dataclasses.dataclass(frozen=True)
class Run:
    """One thread's run of keys: `below` keys cycling from `first_below`
    through [1, threshold], then `above` keys cycling from `first_above`
    through (threshold, INT_MAX]."""

    start: int
    below: int
    first_below: int
    above: int
    first_above: int


def runs(n: int, nthreads: int, maxid: int, threshold: int,
         selectivity: float, tuple_bytes: int = 8) -> list[Run]:
    """The per-thread runs of the reference's parallel generator."""
    npages = (n * tuple_bytes) // PAGE_SIZE + 1
    npages_perthr = npages // nthreads
    per_thr = npages_perthr * (PAGE_SIZE // tuple_bytes)
    if npages_perthr == 0:
        per_thr = n // nthreads
    above_total = int(n * (1.0 - selectivity))
    above_perthr = int(per_thr * (1.0 - selectivity))
    last = n - per_thr * (nthreads - 1)
    above_last = above_total - (nthreads - 1) * above_perthr
    out, offset, offset_above = [], 0, 0
    for t in range(nthreads):
        nt, na = (last, above_last) if t == nthreads - 1 \
            else (per_thr, above_perthr)
        out.append(Run(
            start=offset + offset_above, below=nt - na,
            first_below=(offset + 1) % threshold, above=na,
            first_above=threshold + (offset_above + 1)
            % max(1, maxid - threshold)))
        offset += per_thr - above_perthr
        offset_above += above_perthr
    return out


def _fill_cycle(out: torch.Tensor, first: int, base: int, span: int) -> None:
    """out[i] = base + ((first - base - 1 + i) mod span) + 1, except that a
    cycle starting at `base` itself emits base once first (the reference's
    (offset + 1) % range == 0 edge)."""
    n = out.numel()
    for b0 in range(0, n, BLOCK):
        b1 = min(b0 + BLOCK, n)
        i = torch.arange(b0, b1, dtype=torch.int64, device=out.device)
        out[b0:b1] = base + torch.remainder(first - base - 1 + i, span) + 1
    if n and first == base:
        out[0] = base


def ordered_keys(n: int, nthreads: int, maxid: int, threshold: int,
                 selectivity: float, tuple_bytes: int = 8,
                 device="cpu") -> torch.Tensor:
    """The generator's keys in thread order (int32, on `device`)."""
    keys = torch.empty(n, dtype=torch.int32, device=device)
    for run in runs(n, nthreads, maxid, threshold, selectivity,
                    tuple_bytes):
        s = run.start
        _fill_cycle(keys[s:s + run.below], run.first_below, 0, threshold)
        s += run.below
        _fill_cycle(keys[s:s + run.above], run.first_above, threshold,
                    INT_MAX - threshold)
    return keys


def shuffled(keys: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """keys in the order of one permutation drawn from `gen`."""
    perm = torch.randperm(keys.numel(), generator=gen, device=keys.device)
    return keys[perm]


@dataclasses.dataclass
class Relations:
    """R and S as int32 columns on one device; payload = row number."""

    r_key: torch.Tensor
    r_pay: torch.Tensor
    s_key: torch.Tensor
    s_pay: torch.Tensor

    def column_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.r_key, self.r_pay, self.s_key, self.s_pay))


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded by `seed` (any integer)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def make(config: dict, seed: int, device) -> Relations:
    """R (a unique primary key over [1, r_size]) and S (the threshold
    generator over R's keys at the configuration's selectivity), shuffled
    by one generator seeded by `seed`, on `device`."""
    device = torch.device(device)
    r_size, s_size = config["r_size"], config["s_size"]
    nthreads, tb = config["nthreads"], config["tuple_bytes"]
    gen = generator(seed, device)
    r_key = shuffled(ordered_keys(r_size, nthreads, r_size, r_size, 1.0, tb,
                                  device), gen)
    s_key = shuffled(ordered_keys(s_size, nthreads, INT_MAX, r_size,
                                  config["selectivity"], tb, device), gen)
    return Relations(
        r_key=r_key,
        r_pay=torch.arange(r_size, dtype=torch.int32, device=device),
        s_key=s_key,
        s_pay=torch.arange(s_size, dtype=torch.int32, device=device))
