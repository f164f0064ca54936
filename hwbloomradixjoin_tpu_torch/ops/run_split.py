"""The work split of the kernels that walk a partition's runs.

The bitmap probe (``csrc/bitmap_join.cu``) and the bloom probe
(``csrc/bloom.cu``) read partitioned S through its ``starts``
(``csrc/run_walk.cuh``), and the bitmap build reads partitioned R so
(``plan_share_split`` below).  S is ``nseg`` segments of ``seg_elems``
keys, each with a starts row of ``cat_words`` words over ``2^seg_bits``
buckets and a pad category:

- partition chunks (``partition_pass``): bucket j of every chunk is bucket j;
- pass-2 regions (``multipass.pass2_partition``): bucket j of region r is
  bucket ``r * 2^seg_bits + j``.

A CTA owns a range of ``nb`` buckets of a segment and a span of ``span``
segments (one for regions), stages the range's slices in shared memory and
walks the range's merged run in each segment of the span; the span's CTAs
share each segment's pad run.  ``plan_split`` chooses nb, span and the lanes
a run (``group``) from the geometry alone, on the host, with no read-back;
``cta_work`` is the kernel's own mapping of a CTA to its work, so a test can
check that every run is walked exactly once.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops
from hwbloomradixjoin_tpu_torch.ops.radix import LANES

H100_SMS = 132          # SMs of an H100 SXM; the wrappers pass the card's
MIN_RUN = 2048          # keys a CTA's merged run should hold in a segment
CTAS_PER_SM = 16        # CTAs the split aims for, so the last wave is short


@dataclasses.dataclass(frozen=True)
class RunSplit:
    nseg: int
    seg_elems: int
    cat_words: int
    seg_buckets: int
    regions: bool
    nb: int             # buckets a CTA
    span: int           # segments a CTA
    group: int          # lanes a merged run

    @property
    def nranges(self) -> int:
        return -(-self.seg_buckets // self.nb)

    @property
    def nspans(self) -> int:
        return -(-self.nseg // self.span)

    @property
    def ctas(self) -> int:
        return self.nranges * self.nspans

    def args(self) -> tuple:
        """The kernels' RunGrid fields, in order."""
        return (self.nseg, self.seg_elems, self.cat_words, self.seg_buckets,
                int(self.regions), self.nb, self.span, self.group)


def segment_runs(starts: Optional[torch.Tensor], part: torch.Tensor,
                 seg_bits: int, part_bits: Optional[int] = None):
    """(nseg, seg_elems, cat_words) of a partition's starts table beside its
    keys (2^seg_bits buckets a segment), or None without starts; raises on a
    size mismatch.  With part_bits past seg_bits the segments are pass-2
    regions, 2^(part_bits - seg_bits) of them."""
    if starts is None:
        return None
    cat_words = _cat_words(seg_bits)
    nseg = starts.numel() // cat_words
    if nseg * cat_words != starts.numel() or nseg == 0 \
            or part.numel() % nseg or (part.numel() // nseg) % LANES \
            or (part_bits or 0) > seg_bits \
            and nseg != 1 << (part_bits - seg_bits):
        raise ValueError(f"starts of {starts.numel()} words for "
                         f"{part.numel()} keys at {seg_bits} bits a segment"
                         f" of {part_bits}")
    return nseg, part.numel() // nseg, cat_words


@functools.lru_cache(maxsize=None)
def _cat_words(seg_bits: int) -> int:
    return radix_ops.RadixGeom(part_bits=seg_bits).cat_rows * LANES


def _pow2_at_least(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


@functools.lru_cache(maxsize=256)     # a pure function of sizes, on every launch
def plan_split(runs, seg_bits: int, regions: bool, slice_bytes: int,
               max_stage: int, threads: int, lane_keys: int,
               sms: int = H100_SMS, min_slice: int = 0,
               min_keys_a_word: int = 0) -> Optional[RunSplit]:
    """The split of a walk over `runs` (segment_runs' triple), or None for
    the flat class: one bucket's slice of slice_bytes past max_stage or at
    most min_slice, or fewer than min_keys_a_word keys a word of all the
    slices (a small S: its copies would cost about what its keys do).

    nb doubles from 1 while a CTA's merged run in a segment holds under
    MIN_RUN keys (short runs cost their bounds) and its slices fit
    max_stage.  Chunks take as many spans as bring the grid to CTAS_PER_SM
    CTAs an SM, short of copying the slices more often than S's own bytes
    (the copies come from L2); regions take one segment a CTA.  A merged run
    gets the power of two of lanes at or above its keys over lane_keys (the
    keys a lane loads at once), at most the CTA's threads, and no more
    groups than the span has segments.
    """
    nseg, seg_elems, cat_words = runs
    fs = 1 << seg_bits
    words = (nseg * fs if regions else fs) * slice_bytes // 4
    if not min_slice < slice_bytes <= max_stage \
            or nseg * seg_elems < min_keys_a_word * words:
        return None
    nb = 1
    while nb < fs and 2 * nb * slice_bytes <= max_stage \
            and seg_elems * nb // fs < MIN_RUN:
        nb *= 2
    nranges = -(-fs // nb)
    span = 1
    if not regions:
        nspans = min(nseg, max(1, -(-CTAS_PER_SM * sms // nranges)))
        nspans = max(1, min(nspans, nseg * seg_elems * 4
                            // (fs * slice_bytes)))
        span = -(-nseg // nspans)
    lanes = min(_pow2_at_least(-(-(seg_elems * nb // fs) // lane_keys)),
                threads)
    groups = min(threads // lanes, 1 << (span.bit_length() - 1))
    return RunSplit(nseg=nseg, seg_elems=seg_elems, cat_words=cat_words,
                    seg_buckets=fs, regions=regions, nb=nb, span=span,
                    group=threads // groups)


def cta_work(split: RunSplit, cta: int):
    """(range index, j0, j1, s0, s1, gb0) of CTA `cta`: csrc/run_walk.cuh's
    cta_work.  The CTA walks buckets [j0, j1) of segments [s0, s1) (global
    bucket gb0 + j - j0 of segment s0) and its share of their pad runs."""
    i, sp = cta % split.nranges, cta // split.nranges
    j0 = i * split.nb
    j1 = min(j0 + split.nb, split.seg_buckets)
    s0 = sp * split.span
    s1 = min(s0 + split.span, split.nseg)
    gb0 = s0 * split.seg_buckets + j0 if split.regions else j0
    return i, j0, j1, s0, s1, gb0


def pad_share(split: RunSplit, rng: int, pad_begin: int):
    """Range `rng`'s share of a segment's pad run that starts at pad_begin,
    as csrc/run_walk.cuh's seg_bounds computes it."""
    p0 = min(pad_begin, split.seg_elems)
    length = split.seg_elems - p0
    return (p0 + length * rng // split.nranges,
            p0 + length * (rng + 1) // split.nranges)


# The build's split (csrc/run_walk.cuh walk_share): a range of nb buckets a
# cluster of `share` CTAs, which split the range's runs evenly.  The split
# aims at one wave: as many CTAs as the card holds at once, from the H100's
# shared memory an SM and the registers of its 256-thread CTAs.
MAX_SHARE = 8           # the largest portable cluster
SHARE_STAGE = 32 * 1024  # the slices a range grows to, so CTAs share an SM
SM_SMEM = 228 * 1024    # shared memory an SM
CTA_SMEM_EXTRA = 4096   # a CTA's static shared memory and reserve
MAX_CTAS_PER_SM = 5     # bitmap_build_runs' __launch_bounds__ (48 registers)


@dataclasses.dataclass(frozen=True)
class ShareSplit:
    nseg: int
    seg_elems: int
    cat_words: int
    seg_buckets: int
    nb: int             # buckets a range
    share: int          # CTAs a range (the cluster)

    @property
    def nranges(self) -> int:
        return -(-self.seg_buckets // self.nb)

    @property
    def ctas(self) -> int:
        return self.nranges * self.share

    @property
    def table_bytes(self) -> int:
        """Shared-memory bytes of the walk's table (ShareGrid::table_bytes)."""
        return ((self.nseg + 2) & ~1) * 8 + self.nseg * 16

    def args(self) -> tuple:
        """The kernel's ShareGrid fields, in order."""
        return (self.nseg, self.seg_elems, self.cat_words, self.seg_buckets,
                self.nb, self.share)


@functools.lru_cache(maxsize=256)     # a pure function of sizes, on every launch
def plan_share_split(runs, seg_bits: int, slice_bytes: int, max_stage: int,
                     max_smem: int,
                     sms: int = H100_SMS) -> Optional[ShareSplit]:
    """The build's split of a walk over `runs` (segment_runs' triple,
    partition chunks), or None for the flat class: one bucket's staged
    slice of slice_bytes past max_stage, or the slices and the walk's table
    past max_smem.

    The card holds `wave(nb)` CTAs at once (SM_SMEM over a CTA's slices,
    table and CTA_SMEM_EXTRA, at most MAX_CTAS_PER_SM an SM).  nb doubles
    from 1 while its slices fit SHARE_STAGE and MAX_SHARE CTAs a range
    still fill a wave; share is then the most CTAs a range, a power of two
    up to MAX_SHARE, that one wave holds: more waves cost more than even
    shares win, and clusters of 5 packed worse than of 4 (PERF.md §6).
    """
    nseg, seg_elems, cat_words = runs
    fs = 1 << seg_bits
    if slice_bytes > max_stage:
        return None
    table = ((nseg + 2) & ~1) * 8 + nseg * 16

    def wave(nb):
        per_sm = SM_SMEM // (nb * slice_bytes + table + CTA_SMEM_EXTRA)
        return min(per_sm, MAX_CTAS_PER_SM) * sms

    nb = 1
    while nb < fs and 2 * nb * slice_bytes <= SHARE_STAGE \
            and fs // (2 * nb) * MAX_SHARE >= wave(2 * nb):
        nb *= 2
    nranges = -(-fs // nb)
    fit = max(1, min(MAX_SHARE, wave(nb) // nranges))
    split = ShareSplit(nseg=nseg, seg_elems=seg_elems, cat_words=cat_words,
                       seg_buckets=fs, nb=nb, share=1 << (fit.bit_length() - 1))
    if nb * slice_bytes + split.table_bytes > max_smem:
        return None
    return split


def share_pieces(split: ShareSplit, starts, cta: int, warps: int = 8):
    """The (segment, first key, end key) intervals that CTA `cta` walks, in
    order, warp by warp: csrc/run_walk.cuh's share_table and walk_share
    over a starts table (a numpy array of nseg rows of cat_words)."""
    import numpy as np

    nr, fs, n = split.nranges, split.seg_buckets, split.seg_elems
    rng = cta // split.share
    rank = cta % split.share
    j0, j1 = rng * split.nb, min(rng * split.nb + split.nb, fs)
    st = np.asarray(starts, dtype=np.int64)
    run0 = np.clip(st[:, j0], 0, n)
    run1 = np.maximum(run0, np.clip(st[:, j1], 0, n))
    p0 = np.clip(st[:, fs], 0, n)
    pad0 = p0 + (n - p0) * rng // nr
    pad1 = p0 + (n - p0) * (rng + 1) // nr
    off = np.concatenate([[0], np.cumsum(run1 - run0 + pad1 - pad0)])
    total = int(off[-1])
    c0, c1 = total * rank // split.share, total * (rank + 1) // split.share
    pieces = []
    for w in range(warps):
        pos = c0 + (c1 - c0) * w // warps
        v1 = c0 + (c1 - c0) * (w + 1) // warps
        s = max(int(np.searchsorted(off, pos, side="right")) - 1, 0)
        while pos < v1:
            while off[s + 1] <= pos:
                s += 1
            o = int(off[s])
            x0, x1 = pos - o, min(v1, int(off[s + 1])) - o
            rl = int(run1[s] - run0[s])
            if x0 < rl:
                pieces.append((s, int(run0[s]) + x0, int(run0[s]) + min(x1, rl)))
            if x1 > rl:
                pieces.append((s, int(pad0[s]) + max(x0 - rl, 0),
                               int(pad0[s]) + x1 - rl))
            pos = o + x1
    return pieces


_SMS: dict = {}


def card_sms(device: torch.device) -> int:
    """The card's SM count (read once a device)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]
