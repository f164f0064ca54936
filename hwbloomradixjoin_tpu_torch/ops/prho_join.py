"""The count-table engines (PRHO, PRH, NPO, PRO over a non-unique build) and
materialization.

Counterpart of ``hwbloomradixjoin_tpu/ops/prho_join.py``.  The join is

    R partition (keys + payloads) -> table build -> S partition
    (keys + payloads; keys only for PRH) -> table probe

with R's key range [lo, hi] split into 2^part_bits buckets of 2^shift keys;
bucket b owns the slots [b*slice_rows*128, (b+1)*slice_rows*128) of two
``(F * slice_rows, 128)`` int32 tables, the JAX package's layout: each key's
multiplicity in R, and the sum of its R payloads mod 2^32.  Counts carry
multiplicity, so the build side may repeat keys; the probe returns the match
count and both payload checksums, all sums mod 2^32 like the reference's
unsigned accumulators.

``plan_geometry_counts`` is the JAX package's, unchanged, so both packages
plan the same layout.  ``table_build``, ``probe_count_sums`` and
``materialize_pairs`` (the last phase of a materializing join over a unique
R, ``MaterializePlan``) launch the CUDA kernels of ``csrc/prho_join.cu`` for
tensors on the card and run their plain twins (``build_tables``,
``probe_count_sums_plain``, ``materialize_pairs_plain``) for tensors on the
CPU.  On the card each takes its partition's ``starts`` and walks each
bucket's runs through them (R's for the build, S's for the probe and
materialization), so the TPU kernels' DMA windows (``derive_descs``,
``_probe_geom``) have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops
from hwbloomradixjoin_tpu_torch.ops import run_split
from hwbloomradixjoin_tpu_torch.ops.bitmap_join import CHUNK_ROWS
from hwbloomradixjoin_tpu_torch.ops.radix import LANES
from hwbloomradixjoin_tpu_torch.types import PAD_KEY
from hwbloomradixjoin_tpu_torch.utils.profiling import host_read, span

MAX_SLICE_ROWS = 128       # slice covers 2^14 keys = 64 KiB of counts
MASK32 = 0xFFFFFFFF

# The TPU build deposits payloads as four 8-bit limbs in f32, exact while a
# slot's multiplicity stays below this; at or above it the planner returns
# None and the registry falls back.  The H100 atomics have no such limit;
# the guard stays so both packages choose the same tier (ROADMAP §3).
MULTIPLICITY_GUARD = 65000


def plan_geometry_counts(lo: int, hi: int,
                         num_radix_bits: Optional[int] = None):
    """(part_bits, shift, slice_rows) for word-granular (count) slices.

    Identical to the JAX package's plan_geometry_counts.
    """
    span = hi - lo + 1
    range_bits = max((max(span - 1, 1)).bit_length(), 7)
    lo_bits = max(range_bits - 14, 0)
    hi_bits = max(range_bits - 7, 0)
    part_bits = lo_bits if num_radix_bits is None else (
        min(max(num_radix_bits, lo_bits), hi_bits))
    shift = range_bits - part_bits            # in [7, 14]
    slice_rows = max(1 << (shift - 7), 8)     # 8-row Mosaic alignment
    return part_bits, shift, slice_rows


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def build_tables(r_key: torch.Tensor, r_pay: torch.Tensor, lo: int, hi: int,
                 part_bits: int, shift: int, slice_rows: int):
    """Plain twin of the build: (count, paysum) tables, (F*slice_rows, 128).

    Counts and sums R's keys in [lo, hi] per distinct slot in int64 (the
    payload sums wrap mod 2^32), then writes them into zeroed int32 tables,
    so the only table-sized buffers are the two results.  Slice tails stay
    zero.
    """
    nslots = (1 << part_bits) * slice_rows * LANES
    key = r_key.reshape(-1).long()
    ok = (key >= lo) & (key <= hi)
    norm = key[ok] - lo
    slot = (norm >> shift) * (slice_rows * LANES) + (norm & ((1 << shift) - 1))
    used, inv = torch.unique(slot, return_inverse=True)
    counts = torch.bincount(inv, minlength=used.numel())
    sums = torch.zeros(used.numel(), dtype=torch.int64, device=r_key.device)
    sums.index_add_(0, inv, r_pay.reshape(-1)[ok].long() & MASK32)
    cnt = torch.zeros(nslots, dtype=torch.int32, device=r_key.device)
    pay = torch.zeros_like(cnt)
    cnt[used] = _to_int32(counts & MASK32)
    pay[used] = _to_int32(sums & MASK32)
    rows = nslots // LANES
    return cnt.view(rows, LANES), pay.view(rows, LANES)


def _check_slices(shift: int, slice_rows: int) -> None:
    """A bucket's 2^shift keys must fit its slice, or the kernels' slots run
    into the next slice (past the tables' end for the last bucket)."""
    if 1 << shift > slice_rows * LANES:
        raise ValueError(f"2^{shift} keys a bucket exceed a slice of "
                         f"{slice_rows} rows")


def table_build(r_part: torch.Tensor, rp_part: torch.Tensor, lo: int, hi: int,
                part_bits: int, shift: int, slice_rows: int,
                starts: Optional[torch.Tensor] = None):
    """Build the (count, paysum) tables from partitioned R and its payloads.

    starts: the R partition's starts table (partition_pass_kv's third
    output, range mode over lo and shift with these part_bits).  The card
    requires it: one CTA a bucket walks the bucket's run in every chunk
    through it.  The CPU twin ignores it.  Replaces the Pallas
    build_tables_pallas (prho_join.py:185).
    """
    _check_slices(shift, slice_rows)
    if (hi - lo) >> shift >= 1 << part_bits:
        raise ValueError(f"[{lo}, {hi}] spans more than 2^{part_bits} "
                         f"buckets of 2^{shift} keys")
    if rp_part.shape != r_part.shape:
        raise ValueError(f"payloads {tuple(rp_part.shape)} beside keys "
                         f"{tuple(r_part.shape)}")
    runs = run_split.segment_runs(starts, r_part, part_bits)
    if r_part.device.type == "cpu":
        return build_tables(r_part, rp_part, lo, hi, part_bits, shift,
                            slice_rows)
    if runs is None:
        raise ValueError("table_build on the card needs the partition's "
                         "starts")
    _build.check_cuda(r_part, rp_part, starts)
    shape = ((1 << part_bits) * slice_rows, LANES)
    cnt = torch.empty(shape, dtype=torch.int32, device=r_part.device)
    pay = torch.empty_like(cnt)
    _build.launch("table_build", "hbrj_table_build", r_part.device,
                  r_part.data_ptr(), rp_part.data_ptr(), starts.data_ptr(),
                  *runs, cnt.data_ptr(), pay.data_ptr(), 1 << part_bits, lo,
                  hi, shift, slice_rows * LANES)
    return cnt, pay


def probe_count_sums_plain(cnt_tbl: torch.Tensor, pay_tbl: torch.Tensor,
                           s_part: torch.Tensor, sp_part, lo: int, shift: int,
                           part_bits: int, slice_rows: int) -> torch.Tensor:
    """Plain twin of the probe: int64 (count, r_sum, s_sum), sums mod 2^32.

    A key counts when its ARITHMETIC bucket (int32-wrapped key - lo) >> shift
    lies in [0, F), as the TPU kernel's bucket test has it.  s_sum is 0
    without S payloads (sp_part None).
    """
    key = s_part.reshape(-1).long()
    norm = (key - lo + (1 << 31)) % (1 << 32) - (1 << 31)   # int32 wrap
    bucket = norm >> shift
    ok = (bucket >= 0) & (bucket < (1 << part_bits))
    slot = torch.where(ok, bucket * (slice_rows * LANES)
                       + (norm & ((1 << shift) - 1)), 0)
    c = cnt_tbl.reshape(-1)[slot].long() * ok
    p = (pay_tbl.reshape(-1)[slot].long() & MASK32) * ok
    if sp_part is None:
        s_sum = torch.zeros((), dtype=torch.int64, device=key.device)
    else:
        s_sum = ((sp_part.reshape(-1).long() & MASK32) * c & MASK32).sum()
    return torch.stack([c.sum(), p.sum() & MASK32, s_sum & MASK32])


def probe_count_sums(cnt_tbl: torch.Tensor, pay_tbl: torch.Tensor,
                     s_part: torch.Tensor, sp_part, lo: int, shift: int,
                     part_bits: int, slice_rows: int,
                     starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Probe partitioned S (and its payloads, or None) against the tables.

    Returns a (3,) int64 tensor on s_part's device: the match count, the sum
    of matched R payloads and the sum of S payload * multiplicity, both mod
    2^32 (s_sum 0 without S payloads).  starts: the S partition's starts
    table (range mode over lo and shift at these part_bits, the pad category
    kept).  The card requires it: one CTA a bucket range walks the range's
    runs in every chunk through it.  The CPU twin ignores it.  Replaces the
    Pallas probe_count_sums (prho_join.py:351).
    """
    _check_slices(shift, slice_rows)
    runs = run_split.segment_runs(starts, s_part, part_bits)
    if s_part.device.type == "cpu":
        return probe_count_sums_plain(cnt_tbl, pay_tbl, s_part, sp_part, lo,
                                      shift, part_bits, slice_rows)
    if runs is None:
        raise ValueError("probe_count_sums on the card needs the S "
                         "partition's starts")
    parts = (s_part,) if sp_part is None else (s_part, sp_part)
    _build.check_cuda(cnt_tbl, pay_tbl, starts, *parts)
    _check_tables(cnt_tbl, pay_tbl, part_bits, shift, slice_rows)
    if sp_part is not None and sp_part.shape != s_part.shape:
        raise ValueError(f"payloads {tuple(sp_part.shape)} beside keys "
                         f"{tuple(s_part.shape)}")
    out = torch.empty(3, dtype=torch.int64, device=s_part.device)
    _build.launch("table_probe", "hbrj_table_probe", s_part.device,
                  cnt_tbl.data_ptr(), pay_tbl.data_ptr(), s_part.data_ptr(),
                  None if sp_part is None else sp_part.data_ptr(),
                  starts.data_ptr(), *runs, out.data_ptr(), lo, shift,
                  1 << part_bits, slice_rows * LANES)
    return out


def _check_tables(cnt_tbl, pay_tbl, part_bits: int, shift: int,
                  slice_rows: int) -> None:
    _check_slices(shift, slice_rows)
    nslots = (1 << part_bits) * slice_rows * LANES
    if cnt_tbl.numel() != nslots or pay_tbl.numel() != nslots:
        raise ValueError(f"tables of {cnt_tbl.numel()}, {pay_tbl.numel()} "
                         f"slots for geometry ({part_bits}, {shift}, "
                         f"{slice_rows})")


def materialize_pairs_plain(cnt_tbl: torch.Tensor, pay_tbl: torch.Tensor,
                            s_part: torch.Tensor, sp_part: torch.Tensor,
                            lo: int, shift: int, part_bits: int,
                            slice_rows: int):
    """Plain twin of materialize_pairs: (out_r, out_s, out_k, count).

    Slot i of the three int32 images holds (r_pay, s_pay, key) when S key i
    lies in a bucket (the arithmetic test of probe_count_sums_plain) and its
    count slot is > 0, PAD otherwise; count is an int64 scalar.
    """
    key = s_part.long()
    norm = (key - lo + (1 << 31)) % (1 << 32) - (1 << 31)   # int32 wrap
    bucket = norm >> shift
    ok = (bucket >= 0) & (bucket < (1 << part_bits))
    slot = torch.where(ok, bucket * (slice_rows * LANES)
                       + (norm & ((1 << shift) - 1)), 0)
    hit = ok & (cnt_tbl.reshape(-1)[slot] > 0)
    pad = torch.tensor(PAD_KEY, dtype=torch.int32, device=s_part.device)
    return (torch.where(hit, pay_tbl.reshape(-1)[slot], pad),
            torch.where(hit, sp_part, pad), torch.where(hit, s_part, pad),
            hit.sum())


def materialize_pairs(cnt_tbl: torch.Tensor, pay_tbl: torch.Tensor,
                      s_part: torch.Tensor, sp_part: torch.Tensor, lo: int,
                      shift: int, part_bits: int, slice_rows: int,
                      starts: Optional[torch.Tensor] = None):
    """Emit each matched S slot's (r_pay, s_pay, key) for a unique R.

    Returns three int32 images of s_part's shape, slot for slot: the pair
    and key where S key i has a match, PAD elsewhere; and the match count
    as an int64 scalar tensor.  The tables must come from a unique R (every
    count slot 0 or 1: the payload slot then holds the R payload).  starts:
    the S partition's starts, as for probe_count_sums (the card requires
    it, the CPU twin ignores it).  This layout, congruent with partitioned
    S, replaces the TPU kernel's staged-window image; the contract is the
    pair multiset and the count, not the order.  Replaces the Pallas
    materialize_pairs (prho_join.py:759).
    """
    _check_tables(cnt_tbl, pay_tbl, part_bits, shift, slice_rows)
    if sp_part.shape != s_part.shape:
        raise ValueError(f"payloads {tuple(sp_part.shape)} beside keys "
                         f"{tuple(s_part.shape)}")
    runs = run_split.segment_runs(starts, s_part, part_bits)
    if s_part.device.type == "cpu":
        return materialize_pairs_plain(cnt_tbl, pay_tbl, s_part, sp_part, lo,
                                       shift, part_bits, slice_rows)
    if runs is None:
        raise ValueError("materialize_pairs on the card needs the S "
                         "partition's starts")
    _build.check_cuda(cnt_tbl, pay_tbl, s_part, sp_part, starts)
    out_r, out_s, out_k = (torch.empty_like(s_part) for _ in range(3))
    count = torch.empty((), dtype=torch.int64, device=s_part.device)
    _build.launch("materialize", "hbrj_materialize", s_part.device,
                  cnt_tbl.data_ptr(), pay_tbl.data_ptr(), s_part.data_ptr(),
                  sp_part.data_ptr(), starts.data_ptr(), *runs,
                  out_r.data_ptr(), out_s.data_ptr(), out_k.data_ptr(),
                  count.data_ptr(), lo, shift, 1 << part_bits,
                  slice_rows * LANES)
    return out_r, out_s, out_k, count


def plan_tables_build(r_key, r_pay, lo: int, hi: int, part_bits: int,
                      shift: int, chunk_rows: int = CHUNK_ROWS,
                      device="cuda"):
    """Plan the R-side build: returns (rk_in, rp_in, geom).

    rk_in/rp_in are R's keys and payloads chunk-padded with PAD on `device`;
    geom partitions them (and S) with the pad category kept, as in the JAX
    package.  PrhoPlan.r_partition and .build run the build.
    """
    if r_pay.shape[0] != r_key.shape[0]:
        raise ValueError(f"{r_pay.shape[0]} payloads for {r_key.shape[0]} "
                         "keys")
    geom = radix_ops.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits,
                               lo=lo, hi=hi, shift=shift)
    chunk = chunk_rows * LANES
    with span("hbrj.plan.pad_r"):
        return (radix_ops._chunk_pad(r_key, chunk, device),
                radix_ops._chunk_pad(r_pay, chunk, device), geom)


@dataclasses.dataclass
class PrhoPlan:
    """A planned count-table join over device-resident, chunk-padded inputs.

    full() runs the whole join (R partition, table build, S partition,
    probe) and returns (count, r_sum, s_sum) as a (3,) int64 device tensor
    without synchronising; full_sums() reads it back as (int, uint32,
    uint32).  sp_in is None for PRH, whose S side moves keys only and whose
    s_sum is 0.  phase_fns() gives one callable per phase, each re-running
    that phase on the inputs planning produced.  Spans and run() as
    bitmap_join.RadixJoinPlan's.
    """

    rk_in: torch.Tensor
    rp_in: torch.Tensor
    sk_in: torch.Tensor
    sp_in: Optional[torch.Tensor]
    lo: int
    hi: int
    geom: radix_ops.RadixGeom        # R and S partition
    slice_rows: int
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.sk_in.device

    def r_partition(self):
        with span("hbrj.r_partition"):
            return radix_ops.partition_pass_kv(self.rk_in, self.rp_in,
                                               self.geom)

    def build(self, r_part):
        g = self.geom
        with span("hbrj.build"):
            return table_build(r_part[0], r_part[1], self.lo, self.hi,
                               g.part_bits, g.shift, self.slice_rows,
                               r_part[2])

    def s_partition(self):
        """(keys, payloads or None, starts) of partitioned S."""
        with span("hbrj.s_partition"):
            if self.sp_in is None:
                keys, starts = radix_ops.partition_pass(self.sk_in,
                                                        self.geom)
                return keys, None, starts
            return radix_ops.partition_pass_kv(self.sk_in, self.sp_in,
                                               self.geom)

    def probe(self, tables, s_part) -> torch.Tensor:
        g = self.geom
        with span("hbrj.probe"):
            return probe_count_sums(tables[0], tables[1], s_part[0],
                                    s_part[1], self.lo, g.shift, g.part_bits,
                                    self.slice_rows, s_part[2])

    def run(self) -> torch.Tensor:
        tables = self.build(self.r_partition())
        return self.probe(tables, self.s_partition())

    def full(self) -> torch.Tensor:
        with span("hbrj.full"):
            return self.run()

    def full_sums(self):
        return tuple(host_read(self.full()).tolist())

    def _intermediates(self) -> dict:
        if not self._cache:
            r_part = self.r_partition()
            self._cache.update(r_part=r_part, tables=self.build(r_part),
                               s_part=self.s_partition())
        return self._cache

    def phase_fns(self) -> dict:
        """name -> zero-argument callable re-running that phase, join order."""
        m = self._intermediates()
        return {"r_partition": self.r_partition,
                "build": lambda: self.build(m["r_part"]),
                "s_partition": self.s_partition,
                "probe": lambda: self.probe(m["tables"], m["s_part"])}


@dataclasses.dataclass
class MaterializePlan(PrhoPlan):
    """PrhoPlan whose last phase emits the matched pairs (unique R).

    full() runs R partition, table build, S partition (keys and payloads)
    and materialize_pairs, and returns (out_r, out_s, out_k, count) without
    synchronising; the timed join thus builds its tables, unlike the JAX
    package's timed function, which reused the tables built at plan time.
    """

    def probe(self, tables, s_part):
        g = self.geom
        with span("hbrj.materialize"):
            return materialize_pairs(tables[0], tables[1], s_part[0],
                                     s_part[1], self.lo, g.shift,
                                     g.part_bits, self.slice_rows, s_part[2])

    def phase_fns(self) -> dict:
        fns = super().phase_fns()
        fns["materialize"] = fns.pop("probe")
        return fns


def _plan(r_key, r_pay, s_key, s_pay, lo: int, hi: int, device, chunk_rows,
          num_radix_bits, plan_cls=PrhoPlan,
          max_count: int = MULTIPLICITY_GUARD - 1):
    if s_pay is not None and s_pay.shape[0] != s_key.shape[0]:
        raise ValueError(f"{s_pay.shape[0]} payloads for {s_key.shape[0]} "
                         "keys")
    device = torch.device(device)
    part_bits, shift, slice_rows = plan_geometry_counts(lo, hi,
                                                        num_radix_bits)
    rk_in, rp_in, geom = plan_tables_build(r_key, r_pay, lo, hi, part_bits,
                                           shift, chunk_rows, device)
    chunk = chunk_rows * LANES
    with span("hbrj.plan.pad_s"):
        sk_in = radix_ops._chunk_pad(s_key, chunk, device)
        sp_in = None if s_pay is None \
            else radix_ops._chunk_pad(s_pay, chunk, device)
    plan = plan_cls(rk_in=rk_in, rp_in=rp_in, sk_in=sk_in, sp_in=sp_in,
                    lo=lo, hi=hi, geom=geom, slice_rows=slice_rows)
    # the JAX package's guard on the largest multiplicity (one plan-time
    # sync); the tables built here stay in the plan for phase timing
    with span("hbrj.plan.multiplicity_guard"):
        cnt_tbl = plan._intermediates()["tables"][0]
        if host_read(cnt_tbl.max()) > max_count:
            return None
    return plan


def plan_prho_join(r_key, r_pay, s_key, s_pay, lo: int, hi: int,
                   device="cuda", chunk_rows: int = CHUNK_ROWS,
                   num_radix_bits: Optional[int] = None):
    """PRHO plan: count/pay tables + payload-moving S partition + probe.

    Works for non-unique R (counts carry multiplicity).  r_*/s_*: numpy
    arrays (padded on the host) or tensors; device: where the join runs, the
    card unless the caller asks for the CPU.  Returns None when a key repeats
    MULTIPLICITY_GUARD times or more, like the JAX package.
    """
    return _plan(r_key, r_pay, s_key, s_pay, lo, hi, device, chunk_rows,
                 num_radix_bits)


def plan_prh_join(r_key, r_pay, s_key, lo: int, hi: int, device="cuda",
                  chunk_rows: int = CHUNK_ROWS,
                  num_radix_bits: Optional[int] = None):
    """PRH plan: PRHO's count/paysum-table engine with a keys-only S side.

    The probe accumulates no S checksum, so full_sums() gives (count,
    r_sum, 0), as in the JAX package.  Non-unique R supported; None on the
    multiplicity guard.
    """
    return _plan(r_key, r_pay, s_key, None, lo, hi, device, chunk_rows,
                 num_radix_bits)


def plan_materialize_join(r_key, r_pay, s_key, s_pay, lo: int, hi: int,
                          device="cuda", chunk_rows: int = CHUNK_ROWS,
                          num_radix_bits: Optional[int] = None):
    """Materialization plan for a unique R: a MaterializePlan, or None when
    a key repeats in R (pairs would need per-key R lists; the registry's
    portable tier serves that), as the JAX plan_materialize_join."""
    return _plan(r_key, r_pay, s_key, s_pay, lo, hi, device, chunk_rows,
                 num_radix_bits, plan_cls=MaterializePlan, max_count=1)
