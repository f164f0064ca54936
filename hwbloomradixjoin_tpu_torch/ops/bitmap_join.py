"""The PRO radix-join engine: MSB radix partition + exact-bitmap probe.

Counterpart of ``hwbloomradixjoin_tpu/ops/bitmap_join.py``.  The join is

    R partition -> bitmap build -> [S survivor compaction] -> S partition
    -> bitmap probe

with R's key range [lo, hi] split into 2^part_bits buckets of 2^shift keys;
bucket b owns the bitmap rows [b*sl_rows, (b+1)*sl_rows) of a
``(F * sl_rows, 128)`` int32 bitmap, the JAX package's layout.  Unique build
keys make the bitmap exact (one bit per key), so the probe count needs no
verification.

The geometry planners are the JAX package's, unchanged, so both packages
choose the same (part_bits, shift, sl_rows) and their layouts compare
directly.  Their constants are a TPU cost model; on the H100 they only fix
the layout.

``bitmap_build`` and ``bitmap_probe_count`` launch the CUDA kernels of
``csrc/bitmap_join.cu`` for tensors on the card and run their plain twins
(``build_bitmap``, ``bitmap_probe_count_plain``) for tensors on the CPU.
Unlike the TPU kernels they need no DMA window descriptors
(``derive_descs``): the build takes the R partition's ``starts`` and ORs
every in-range key of each bucket range's runs into the range's slices in
shared memory, a cluster of CTAs sharing each range's runs evenly; the
probe takes the S partition's ``starts`` (chunks, or pass-2 regions) and
walks each bucket range's runs with the range's bitmap slices in shared
memory (``ops/run_split.py``), every key counted exactly once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops
from hwbloomradixjoin_tpu_torch.ops import run_split
from hwbloomradixjoin_tpu_torch.ops.radix import LANES
from hwbloomradixjoin_tpu_torch.utils.profiling import host_read, span

CHUNK_ROWS = 4096          # partition chunk: 512K elements (2 MiB keys)

# The JAX planner's cost model (its bitmap_join.py constants, unchanged):
# a split bit's cost and a resident slice row's, a key.  Kept so both
# packages choose one layout; they are not the card's.  The card's own cost
# of a split bit comes from tools/part_bench.py --widths (PERF.md), and an
# H100 cost model is later work.
SPLIT_NS_PER_BIT = 0.185
LADDER_NS_PER_ROW = 0.004
SHIFT_MAX = 25                 # sl_rows cap 2^13 rows = 4 MiB slice
# The probe kernel's staging: 256 threads a CTA, 16 keys a lane in flight,
# at most 128 KiB of bitmap slices (one bucket's live words up to shift
# 20).  The flat class takes the rest, and two geometries where the flat
# stream is faster (python -m hwbloomradixjoin_tpu_torch.flat_split, PERF.md
# §6): live slices of at most 4 KiB, whose words stay in L1 (4d's 512
# bytes), and an S of fewer than 8 keys a bitmap word (compacted S at
# q = 0.01, whose runs are skewed: one CTA would hold the hot bucket's).
PROBE_THREADS = 256
PROBE_LANE_KEYS = 16
PROBE_MAX_STAGE = 128 * 1024
PROBE_MIN_SLICE = 4 * 1024
PROBE_MIN_KEYS_A_WORD = 8
# The build kernel's staging: at most 128 KiB of one bucket's live words (a
# shift up to 20; the flat class, atomicOr into a zeroed bitmap, past it),
# and at most 200 KiB of slices and walk table a CTA.
BUILD_MAX_STAGE = 128 * 1024
BUILD_MAX_SMEM = 200 * 1024


def plan_geometry(lo: int, hi: int, num_radix_bits: Optional[int] = None,
                  survivor_frac: float = 1.0):
    """Derive (part_bits, shift, sl_rows) from the build-side key range.

    Each bucket covers 2^shift keys and owns a bitmap slice of
    sl_rows = max(2^(shift-12), 8) rows of 128 words.  Fan-out minimizes the
    TPU cost model above; num_radix_bits overrides it within the valid
    window.  Identical to the JAX package's plan_geometry.
    """
    span = hi - lo + 1
    range_bits = max((max(span - 1, 1)).bit_length(), 12)
    lo_bits = max(range_bits - SHIFT_MAX, 0)
    hi_bits = max(range_bits - 12, 0)
    sf = min(max(survivor_frac, 1e-4), 1.0)

    def cost(bits):
        sl = max(1 << (range_bits - bits - 12), 8)
        return (bits + 1) * SPLIT_NS_PER_BIT + sf * LADDER_NS_PER_ROW * sl

    if num_radix_bits is None:
        part_bits = min(range(lo_bits, hi_bits + 1), key=cost)
    else:
        part_bits = min(max(num_radix_bits, lo_bits), hi_bits)
    shift = range_bits - part_bits
    sl_rows = max(1 << (shift - 12), 8)
    return part_bits, shift, sl_rows


def plan_build_geometry(lo: int, hi: int, part_bits: int, shift: int,
                        sl_rows: int):
    """R-side (build) geometry: may be FINER than the probe geometry.

    With shift > 19 both layouts are unpadded (sl_rows == 2^(shift-12)), so
    word(norm) = norm >> 5 row-major and a build partition at shift_r = 19
    tiles the probe's global bitmap exactly.  Identical to the JAX package.
    """
    span = hi - lo + 1
    range_bits = max((max(span - 1, 1)).bit_length(), 12)
    shift_r = 19
    if shift > shift_r and range_bits - shift_r >= 1:
        bits_r = range_bits - shift_r
        return bits_r, shift_r, 1 << (shift_r - 12)
    return part_bits, shift, sl_rows


def build_bitmap(r_key: torch.Tensor, lo: int, hi: int, part_bits: int,
                 shift: int, sl_rows: int,
                 starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of the build: exact bitmap of R's keys in [lo, hi].

    Global bit of a key = bucket * sl_rows*4096 + (norm & (2^shift - 1));
    each distinct bit adds 2^(bit & 31) into word bit >> 5 (bit j of a word
    is weight 2^j), so the result is the OR of the keys' bits for any
    multiset, and the temporaries are one int64 a word and a few a key.
    starts: the R partition's starts, if r_key is partitioned; its size is
    checked (build_split) and it is otherwise unread.
    """
    if starts is not None:
        build_split(r_key, starts, shift, part_bits)
    slice_bits = sl_rows * LANES * 32
    nwords = (1 << part_bits) * slice_bits // 32
    key = r_key.reshape(-1).long()
    ok = (key >= lo) & (key <= hi)
    norm = key[ok] - lo
    bitpos = torch.unique((norm >> shift) * slice_bits
                          + (norm & ((1 << shift) - 1)))
    words = torch.zeros(nwords, dtype=torch.int64, device=r_key.device)
    words.index_add_(0, bitpos >> 5, torch.ones_like(bitpos) << (bitpos & 31))
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).view((1 << part_bits) * sl_rows, LANES)


def build_split(r_part: torch.Tensor, starts: torch.Tensor, shift: int,
                part_bits: int, sms: int = run_split.H100_SMS):
    """The build kernel's split of partitioned R (run_split.plan_share_split)
    or None for the flat class; raises on starts of the wrong size."""
    runs = run_split.segment_runs(starts, r_part, part_bits)
    return run_split.plan_share_split(runs, part_bits, 4 * live_words(shift),
                                      BUILD_MAX_STAGE, BUILD_MAX_SMEM, sms)


def bitmap_build(r_part: torch.Tensor, lo: int, hi: int, part_bits: int,
                 shift: int, sl_rows: int,
                 starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Build the exact bitmap from partitioned R: (F * sl_rows, 128) int32.

    starts: the R partition's starts (partition_pass's second output at
    this geometry).  The card requires it: the kernel walks each bucket
    range's runs through it.  The CPU twin checks its size and ignores it.
    Replaces the Pallas bitmap_build_pallas (bitmap_join.py:449).
    """
    if r_part.device.type == "cpu":
        return build_bitmap(r_part, lo, hi, part_bits, shift, sl_rows, starts)
    if starts is None:
        raise ValueError("bitmap_build on the card needs the R partition's "
                         "starts")
    _build.check_cuda(r_part, starts)
    if hi - lo >= (1 << part_bits) << shift:
        raise ValueError(f"key range [{lo}, {hi}] past {1 << part_bits} "
                         f"buckets of 2^{shift} keys")
    split = build_split(r_part, starts, shift, part_bits,
                        run_split.card_sms(r_part.device))
    grid = (0,) * 6 if split is None else split.args()
    bm = torch.empty(((1 << part_bits) * sl_rows, LANES), dtype=torch.int32,
                     device=r_part.device)
    sync = torch.empty(2, dtype=torch.int32, device=r_part.device)
    _build.launch("bitmap_build", "hbrj_bitmap_build", r_part.device,
                  r_part.data_ptr(), r_part.numel(), starts.data_ptr(),
                  bm.data_ptr(), bm.numel(), sync.data_ptr(), lo, hi, shift,
                  sl_rows * LANES, *grid, live_words(shift))
    return bm


def bitmap_probe_count_plain(bitmap: torch.Tensor, s_part: torch.Tensor,
                             lo: int, shift: int, part_bits: int,
                             sl_rows: int) -> torch.Tensor:
    """Plain twin of the probe: int64 count of S keys whose bit is set.

    A key counts when its ARITHMETIC bucket (int32-wrapped key - lo) >> shift
    lies in [0, F), as the TPU kernel's bucket test has it.
    """
    key = s_part.reshape(-1).long()
    norm = (key - lo + (1 << 31)) % (1 << 32) - (1 << 31)   # int32 wrap
    bucket = norm >> shift
    ok = (bucket >= 0) & (bucket < (1 << part_bits))
    local = norm & ((1 << shift) - 1)
    word = torch.where(ok, bucket * (sl_rows * LANES) + (local >> 5), 0)
    bit = (bitmap.reshape(-1)[word].long() >> (norm & 31)) & 1
    return (bit * ok).sum()


def probe_split(s_part: torch.Tensor, starts: torch.Tensor, shift: int,
                part_bits: int, seg_bits: Optional[int] = None,
                sms: int = run_split.H100_SMS):
    """The probe kernel's split of partitioned S (run_split.plan_split), or
    None for the flat class (see PROBE_MAX_STAGE and its neighbours).

    seg_bits: the bucket bits of a segment, part_bits for partition chunks
    (None), fewer for pass-2 regions (b2: bucket j of region r is r * 2^b2
    + j); raises on starts of the wrong size."""
    seg_bits = part_bits if seg_bits is None else seg_bits
    runs = run_split.segment_runs(starts, s_part, seg_bits, part_bits)
    return run_split.plan_split(runs, seg_bits, seg_bits < part_bits,
                                4 * live_words(shift), PROBE_MAX_STAGE,
                                PROBE_THREADS, PROBE_LANE_KEYS, sms,
                                PROBE_MIN_SLICE, PROBE_MIN_KEYS_A_WORD)


def live_words(shift: int) -> int:
    """The words of a bucket's slice that keys address (2^shift bits),
    rounded up to whole 16-byte copies."""
    return max((1 << shift) >> 5, 4)


def bitmap_probe_count(bitmap: torch.Tensor, s_part: torch.Tensor, lo: int,
                       shift: int, part_bits: int, sl_rows: int,
                       starts: Optional[torch.Tensor] = None,
                       seg_bits: Optional[int] = None) -> torch.Tensor:
    """Count S matches against the bitmap: 0-d int64 tensor on s_part's device.

    starts: the S partition's starts (partition_pass's second output at
    these part_bits, or pass2_partition's starts2 with seg_bits = b2).  The
    card requires it: the kernel walks each bucket range's runs through it.
    The CPU twin checks its size and ignores it.  Replaces the Pallas
    bitmap_probe_count (bitmap_join.py:314).
    """
    if s_part.device.type == "cpu":
        if starts is not None:
            probe_split(s_part, starts, shift, part_bits, seg_bits)
        return bitmap_probe_count_plain(bitmap, s_part, lo, shift, part_bits,
                                        sl_rows)
    if starts is None:
        raise ValueError("bitmap_probe_count on the card needs the S "
                         "partition's starts")
    _build.check_cuda(bitmap, s_part, starts)
    if bitmap.numel() != (1 << part_bits) * sl_rows * LANES:
        raise ValueError(f"bitmap of {bitmap.numel()} words for geometry "
                         f"({part_bits}, {shift}, {sl_rows})")
    split = probe_split(s_part, starts, shift, part_bits, seg_bits,
                        run_split.card_sms(s_part.device))
    grid = (0,) * 8 if split is None else split.args()
    out = torch.empty((), dtype=torch.int64, device=s_part.device)
    _build.launch("bitmap_probe", "hbrj_bitmap_probe", s_part.device,
                  bitmap.data_ptr(), s_part.data_ptr(), s_part.numel(),
                  starts.data_ptr(), out.data_ptr(), lo, shift,
                  1 << part_bits, sl_rows * LANES, *grid, live_words(shift))
    return out


def plan_bitmap_build(r_key, lo: int, hi: int, part_bits: int, shift: int,
                      sl_rows: int, chunk_rows: int = CHUNK_ROWS,
                      device="cuda"):
    """Plan the R-side build: returns (rk_in, rgeom).

    rk_in is R chunk-padded with PAD; rgeom partitions it, dropping the pad
    category when PAD cannot alias a bucket (R holds no out-of-range keys).
    RadixJoinPlan.r_partition and .build run the build.  The TPU plan synced
    once here to size its DMA windows; the port needs no windows, so planning
    the build reads nothing back.
    """
    rgeom = radix_ops.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits,
                                lo=lo, hi=hi, shift=shift,
                                pad_cat=not radix_ops.pad_cat_safe(lo, hi))
    with span("hbrj.plan.pad_r"):
        return radix_ops._chunk_pad(r_key, chunk_rows * LANES, device), rgeom


@dataclasses.dataclass
class RadixJoinPlan:
    """A planned radix join over device-resident, chunk-padded inputs.

    full() runs the whole join (R partition, build, [compaction], S
    partition, probe) and returns the count as a device tensor without
    synchronising; full_count() reads it back.  phase_fns() gives one
    callable per phase, each re-running that phase on the inputs planning
    produced, for phase timing.  Each phase runs in its span
    (``hbrj.r_partition``, ...), the join in ``hbrj.full``; run() is the
    join without it.
    """

    rk_in: torch.Tensor
    sk_in: torch.Tensor
    lo: int
    hi: int
    rgeom: radix_ops.RadixGeom       # build partition (R)
    r_sl_rows: int
    sgeom: radix_ops.RadixGeom       # probe partition (S)
    sl_rows: int
    cap_rows: Optional[int]          # survivor compaction cap; None = off
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.sk_in.device

    def r_partition(self):
        with span("hbrj.r_partition"):
            return radix_ops.partition_pass(self.rk_in, self.rgeom)

    def build(self, r_part: torch.Tensor,
              starts: Optional[torch.Tensor] = None) -> torch.Tensor:
        g = self.rgeom
        with span("hbrj.build"):
            return bitmap_build(r_part, self.lo, self.hi, g.part_bits,
                                g.shift, self.r_sl_rows, starts)

    def s_effective(self) -> torch.Tensor:
        """S as the partition sees it: compacted survivors, or S itself."""
        if self.cap_rows is None:
            return self.sk_in
        chunk_rows = self.sgeom.chunk_rows
        with span("hbrj.compact"):
            ck, _ = radix_ops.compact_pass(self.sk_in, self.lo, self.hi,
                                           chunk_rows, cap_rows=self.cap_rows)
            return radix_ops._chunk_pad(ck.view(-1), chunk_rows * LANES,
                                        ck.device)

    def s_partition(self, s_eff: torch.Tensor):
        with span("hbrj.s_partition"):
            return radix_ops.partition_pass(s_eff, self.sgeom)

    def probe(self, bitmap: torch.Tensor, s_part: torch.Tensor,
              starts: torch.Tensor):
        g = self.sgeom
        with span("hbrj.probe"):
            return bitmap_probe_count(bitmap, s_part, self.lo, g.shift,
                                      g.part_bits, self.sl_rows, starts)

    def run(self) -> torch.Tensor:
        bitmap = self.build(*self.r_partition())
        return self.probe(bitmap, *self.s_partition(self.s_effective()))

    def full(self) -> torch.Tensor:
        with span("hbrj.full"):
            return self.run()

    def full_count(self) -> int:
        return host_read(self.full())

    def _intermediates(self) -> dict:
        if not self._cache:
            r_part, r_starts = self.r_partition()
            s_eff = self.s_effective()
            self._cache.update(r_part=r_part, r_starts=r_starts,
                               bitmap=self.build(r_part, r_starts),
                               s_eff=s_eff,
                               s_part=self.s_partition(s_eff))
        return self._cache

    def phase_fns(self) -> dict:
        """name -> zero-argument callable re-running that phase, join order."""
        m = self._intermediates()
        fns = {"r_partition": self.r_partition,
               "build": lambda: self.build(m["r_part"], m["r_starts"])}
        if self.cap_rows is not None:
            fns["compact"] = self.s_effective
        fns["s_partition"] = lambda: self.s_partition(m["s_eff"])
        fns["probe"] = lambda: self.probe(m["bitmap"], *m["s_part"])
        return fns


# The JAX package's window cap (bitmap_join.py:612), kept for its overflow
# flag (see traced_radix_count).
C_ROWS_CAP = 1024


def traced_c_rows(part_bits: int, chunk_rows: int, slack: int = 4) -> int:
    """The rows of the static window the JAX package's sync-free join gives
    a run (its _traced_probe_geom, bitmap_join.py:639-650): `slack` times
    a uniform bucket's mean run, a power of two in [8, min(chunk_rows,
    C_ROWS_CAP)]."""
    mean_rows = max(chunk_rows >> max(part_bits, 0), 1)
    return max(8, min(1 << (slack * mean_rows - 1).bit_length(), chunk_rows,
                      C_ROWS_CAP))


def max_run(starts: torch.Tensor, nchunks: int, part_bits: int):
    """The longest bucket run of a partition (its pad category aside), from
    its starts: a 0-d tensor (JAX bitmap_join.py:669)."""
    st = starts.reshape(nchunks, -1)[:, :(1 << part_bits) + 1]
    return (st[:, 1:] - st[:, :-1]).max()


def traced_radix_count(r_key, s_key, lo: int, hi: int,
                       chunk_rows: Optional[int] = None,
                       num_radix_bits: Optional[int] = None):
    """The JAX package's sync-free bitmap join (bitmap_join.py:674), the
    local join of the distributed engine: (count, overflow), 0-d tensors.

    R partition -> bitmap build -> S partition -> probe at plan_geometry's
    and plan_build_geometry's layouts (survivor_frac 1, no compaction);
    kernels 1, 3 and 4 on the card, their twins on the CPU.  Count only;
    needs unique R keys in [lo, hi].  r_key and s_key: flat int32 tensors
    on the device the join runs on.

    overflow is the JAX package's flag: 1 when a bucket run of a chunk,
    on either side, exceeds the static window that package sizes at
    traced_c_rows, where the JAX count is no longer valid.  The port's
    kernels walk runs of any length, so its count is exact whatever the
    flag says; the flag is kept to be held against JAX's, and the
    distributed join does not read it.  Unlike the
    JAX function this one is not free of host syncs: the build and the
    probe read the partitions' starts back to plan their splits
    (ops/run_split.py).
    """
    chunk_rows = CHUNK_ROWS if chunk_rows is None else chunk_rows
    chunk = chunk_rows * LANES
    dev = r_key.device
    part_bits, shift, sl_rows = plan_geometry(lo, hi, num_radix_bits, 1.0)
    bits_r, shift_r, sl_rows_r = plan_build_geometry(lo, hi, part_bits,
                                                     shift, sl_rows)
    plan = RadixJoinPlan(
        rk_in=radix_ops._chunk_pad(r_key.reshape(-1), chunk, dev),
        sk_in=radix_ops._chunk_pad(s_key.reshape(-1), chunk, dev), lo=lo,
        hi=hi, rgeom=radix_ops.RadixGeom(chunk_rows=chunk_rows,
                                         part_bits=bits_r, lo=lo, hi=hi,
                                         shift=shift_r),
        r_sl_rows=sl_rows_r, sgeom=radix_ops.RadixGeom(
            chunk_rows=chunk_rows, part_bits=part_bits, lo=lo, hi=hi,
            shift=shift), sl_rows=sl_rows, cap_rows=None)
    r_part, r_starts = plan.r_partition()
    bitmap = plan.build(r_part, r_starts)
    s_part, s_starts = plan.s_partition(plan.sk_in)
    count = plan.probe(bitmap, s_part, s_starts)
    # a run of L keys starting mid-row spans ceil(L / 128) + 1 window rows,
    # so a run fits its window when L <= (c_rows - 1) * 128
    ovf = torch.zeros((), dtype=torch.int32, device=dev)
    for part, starts, bits in ((r_part, r_starts, bits_r),
                               (s_part, s_starts, part_bits)):
        nchunks = part.numel() // chunk
        limit = (traced_c_rows(bits, chunk_rows) - 1) * LANES
        ovf += (max_run(starts, nchunks, bits) > limit).int()
    return count, ovf


def plan_radix_join(r_key, s_key, lo: int, hi: int, device="cuda",
                    chunk_rows: int = CHUNK_ROWS,
                    num_radix_bits: Optional[int] = None,
                    survivor_frac: Optional[float] = None) -> RadixJoinPlan:
    """Plan the radix join of unique R keys in [lo, hi] with S.

    r_key/s_key: numpy arrays (padded on the host) or tensors.  device: where
    the join runs, the card unless the caller asks for the CPU.
    survivor_frac: fraction of S inside [lo, hi]; None measures it (one host
    sync, span ``hbrj.plan.survivor_count``).  Under half triggers survivor
    compaction when the compacted stream is at most 60% of S; the per-chunk
    cap comes from one plan-time compaction's live counts (a second host
    sync, ``hbrj.plan.compact_cap``).  As in the JAX package.
    """
    device = torch.device(device)
    chunk = chunk_rows * LANES
    with span("hbrj.plan.pad_s"):
        sk_in = radix_ops._chunk_pad(s_key, chunk, device)
    if survivor_frac is None:
        with span("hbrj.plan.survivor_count"):
            live = ((sk_in >= lo) & (sk_in <= hi)).sum()
            survivor_frac = host_read(live) / sk_in.numel()

    cap_rows = None
    nchunks0 = sk_in.numel() // chunk
    if survivor_frac < 0.5 and nchunks0 > 0:
        with span("hbrj.plan.compact_cap"):
            _, counts0 = radix_ops.compact_pass(sk_in, lo, hi, chunk_rows,
                                                cap_rows=8)
            max_live = host_read(counts0[::8, 0].max())
        cap = min(max((-(-max_live // LANES) + 7) & ~7, 8), chunk_rows)
        if nchunks0 * cap <= (sk_in.numel() // LANES) * 6 // 10:
            cap_rows = cap

    # after compaction split and probe both see survivors only, so the
    # survivor_frac=1 geometry is the optimum (JAX package, same rule)
    part_bits, shift, sl_rows = plan_geometry(
        lo, hi, num_radix_bits, 1.0 if cap_rows is not None else survivor_frac)
    sgeom = radix_ops.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits,
                                lo=lo, hi=hi, shift=shift)
    bits_r, shift_r, sl_rows_r = plan_build_geometry(lo, hi, part_bits, shift,
                                                     sl_rows)
    rk_in, rgeom = plan_bitmap_build(r_key, lo, hi, bits_r, shift_r,
                                     sl_rows_r, chunk_rows, device)
    return RadixJoinPlan(rk_in=rk_in, sk_in=sk_in, lo=lo, hi=hi, rgeom=rgeom,
                         r_sl_rows=sl_rows_r, sgeom=sgeom, sl_rows=sl_rows,
                         cap_rows=cap_rows)
