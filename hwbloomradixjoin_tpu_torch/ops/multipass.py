"""Two-pass radix partitioning: chunk-major pass 1 + contiguous pass 2.

Counterpart of ``hwbloomradixjoin_tpu/ops/multipass.py`` (the reference's
NUM_PASSES = 2: parallel_radix_join.c pass 1 :735 over the high bits, pass 2
:680 re-clustering each pass-1 partition by the next bits).

- Pass 1: ``radix.partition_pass`` by the high b1 bits (or, in hash mode,
  the top b1 bits of the bloom filter's block index).
- Pass 2: ``pass2_partition`` regroups every pass-1 bucket into one
  capacity-padded region of a contiguous bucket-major output, split stably by
  the next b2 bits, plus ``starts2``.  It launches the CUDA kernel of
  ``csrc/multipass.cu`` for a tensor on the card and runs its plain twin
  ``pass2_partition_plain`` for a tensor on the CPU.

The TPU kernel gathered each chunk's run through a DMA window of c1_rows
rows (``_descs1``) and its probe read the regions through tile descriptors
(``derive_descs_contig``).  Neither is ported: pass 2 takes pass 1's
``starts`` and reads each run in place, and the bitmap and bloom probes
walk the regions' runs through ``starts2`` (bucket j of region r is bucket
r * 2^b2 + j), testing each key's own bucket.  The window
geometry (c1_rows) is kept: it fixes which keys the TPU kernel took (range
mode masks the window's slack by bucket, which admits keys above hi inside
the last buckets), the planners' guards, and ``starts2`` past F2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hwbloomradixjoin_tpu_torch.config import RadixConfig
from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import bitmap_join, hashes
from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops
from hwbloomradixjoin_tpu_torch.ops.radix import LANES
from hwbloomradixjoin_tpu_torch.types import PAD_KEY
from hwbloomradixjoin_tpu_torch.utils.profiling import host_read, span

# TPU limits kept on purpose for range-mode plans, so both packages choose
# the same two-pass join (ROADMAP §3): pass 2 staged every chunk's window of a
# bucket in one VMEM buffer of at most 8 x SBUF_BUDGET_ROWS (4096) rows, with
# one descriptor a chunk.  The hash-mode prune does not apply them: its
# kernel reads each run in place.
GATHER_BUDGET_ROWS = 8 * 4096
MAX_RANGE_CHUNKS = 512          # range-mode plans (multipass.py:260)
# Widest pass 2 of the kernel: b2 = bits // 2 of the planners' 20 bits.
MAX_PASS2_BITS = 10


@dataclasses.dataclass(frozen=True)
class Pass2Geom:
    b1: int               # pass-1 bits (high)
    b2: int               # pass-2 bits
    shift1: int
    shift2: int
    lo: int
    hi: int
    chunk_rows: int
    nchunks: int
    c1_rows: int          # rows of the TPU kernel's window of a run
    cap_rows: int         # output region rows per pass-1 bucket
    cat2_rows: int        # rows of the pass-2 starts block
    # hash mode (bloom prune): categories from the filter's block index
    # crc32c(seed, key) & (2^hash_bits - 1) instead of the key value
    hash_seed: Optional[int] = None
    hash_bits: int = 0

    @property
    def gbuf_rows(self) -> int:
        return self.nchunks * self.c1_rows


def _sub_category(keys: torch.Tensor, b: torch.Tensor,
                  geom: Pass2Geom) -> torch.Tensor:
    """Pass-2 category of each key in region b: the next b2 bits for a live
    key of bucket b, F2 for every other key (int64)."""
    F2 = 1 << geom.b2
    k = keys.long()
    if geom.hash_seed is not None:
        block = hashes.hash_crc(geom.hash_seed, keys) \
            & ((1 << geom.hash_bits) - 1)
        mine = (block >> (geom.hash_bits - geom.b1)) == b
        sub = (block >> (geom.hash_bits - geom.b1 - geom.b2)) & (F2 - 1)
    else:
        norm = (k - geom.lo + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 wrap
        mine = (norm >> geom.shift1) == b            # arithmetic, as the TPU
        sub = ((norm & 0xFFFFFFFF) >> geom.shift2) & (F2 - 1)
    return torch.where(mine & (k != PAD_KEY), sub, F2)


def _check(s_part1: torch.Tensor, starts1: torch.Tensor, geom: Pass2Geom):
    chunk = geom.chunk_rows * LANES
    if s_part1.numel() != geom.nchunks * chunk:
        raise ValueError(f"pass-1 keys of {s_part1.numel()} elements for "
                         f"{geom.nchunks} chunks of {chunk}")
    if starts1.numel() % max(geom.nchunks, 1) \
            or starts1.numel() // max(geom.nchunks, 1) < (1 << geom.b1) + 1:
        raise ValueError(f"pass-1 starts of {starts1.numel()} words for "
                         f"{geom.nchunks} chunks of {1 << geom.b1} buckets")
    if not 8 <= geom.c1_rows <= geom.chunk_rows \
            or geom.cap_rows > geom.gbuf_rows:
        raise ValueError(f"window {geom.c1_rows} rows in chunks of "
                         f"{geom.chunk_rows}, regions of {geom.cap_rows} rows")


def pass2_partition_plain(s_part1: torch.Tensor, starts1: torch.Tensor,
                          geom: Pass2Geom):
    """Plain twin of pass2_partition, the TPU kernel's algorithm: gather
    each chunk's window of each bucket, then a stable torch.sort of every
    region by sub-category."""
    _check(s_part1, starts1, geom)
    F1, F2 = 1 << geom.b1, 1 << geom.b2
    dev = s_part1.device
    chunk = geom.chunk_rows * LANES
    win = geom.c1_rows * LANES
    st = starts1.reshape(geom.nchunks, -1)[:, :F1].long()
    r0 = torch.clamp(st >> 7, max=geom.chunk_rows - geom.c1_rows)  # (t, b)
    t = torch.arange(geom.nchunks, device=dev)[:, None]
    first = (t * chunk + r0 * LANES).T                              # (b, t)
    idx = first[:, :, None] + torch.arange(win, device=dev)
    keys = s_part1.reshape(-1)[idx.reshape(F1, -1)]                 # (b, gbuf)
    b = torch.arange(F1, device=dev)[:, None]
    cat, order = torch.sort(_sub_category(keys, b, geom), dim=1, stable=True)
    cap = geom.cap_rows * LANES
    live = (cat < F2).sum(dim=1, keepdim=True)
    out = torch.where(torch.arange(cap, device=dev) < live,
                      torch.gather(keys, 1, order[:, :cap]), PAD_KEY)
    j = torch.arange(geom.cat2_rows * LANES, device=dev)
    starts2 = torch.searchsorted(cat, j.expand(F1, -1).contiguous())
    return (out.to(torch.int32).view(F1 * geom.cap_rows, LANES),
            starts2.to(torch.int32).view(F1 * geom.cat2_rows, LANES))


def pass2_partition(s_part1: torch.Tensor, starts1: torch.Tensor,
                    geom: Pass2Geom):
    """Regroup pass-1 output into contiguous bucket-major regions.

    s_part1, starts1: partition_pass's output at the pass-1 geometry.
    Returns (s_part2 (F1*cap_rows, 128), starts2 (F1*cat2_rows, 128)):
    region b holds the live keys of bucket b split stably by the next b2
    bits, then PAD; starts2[b][j] counts region b's live keys of
    sub-category < j for j <= F2 (flat offsets within the region) and holds
    nchunks*c1_rows*128 past F2.  Replaces the Pallas pass2_partition
    (multipass.py:118).
    """
    _check(s_part1, starts1, geom)
    if s_part1.device.type == "cpu":
        return pass2_partition_plain(s_part1, starts1, geom)
    _build.check_cuda(s_part1, starts1)
    if geom.b2 > MAX_PASS2_BITS:
        raise ValueError(f"pass 2 of {geom.b2} bits: the kernel takes at most "
                         f"{MAX_PASS2_BITS}")
    F1, F2 = 1 << geom.b1, 1 << geom.b2
    dev = s_part1.device
    out = torch.empty((F1 * geom.cap_rows, LANES), dtype=torch.int32,
                      device=dev)
    starts2 = torch.empty((F1 * geom.cat2_rows, LANES), dtype=torch.int32,
                          device=dev)
    hist = torch.empty(F1 * F2 * geom.nchunks, dtype=torch.int32, device=dev)
    hashed = geom.hash_seed is not None
    _build.launch("pass2_partition_hash" if hashed else "pass2_partition",
                  "hbrj_pass2_partition", dev,
                  s_part1.data_ptr(), starts1.data_ptr(), out.data_ptr(),
                  starts2.data_ptr(), hist.data_ptr(), geom.nchunks,
                  geom.chunk_rows, geom.c1_rows,
                  starts1.numel() // geom.nchunks, geom.b1, geom.b2,
                  geom.cap_rows * LANES, geom.cat2_rows * LANES, int(hashed),
                  (geom.hash_seed or 0) & 0xFFFFFFFF, geom.hash_bits,
                  geom.lo, geom.shift1, geom.shift2)
    return out, starts2


def plan_pass2(s_part1: torch.Tensor, starts1: torch.Tensor, b1: int,
               b2: int, chunk_rows: int, max_chunks: Optional[int], **mode):
    """Pass-2 geometry from pass 1's starts (one host sync), or None.

    c1_rows is the TPU window of the largest run plus a row of slack;
    cap_rows the largest bucket plus a row a chunk.  With max_chunks, the
    TPU kernel's limits hold (the JAX planner's None): a run (nearly)
    filling a chunk, a gather buffer past GATHER_BUDGET_ROWS, or more than
    max_chunks chunks.  max_chunks=None (the hash-mode prune, whose kernel
    reads each run in place) lifts them, clamps the window to a chunk, and
    returns None only for a skewed S: a bucket past twice the mean plus a
    chunk, whose region capacity, taken by all F1 regions, would multiply
    the output.  mode: lo, hi, shift1, shift2 (range) or hash_seed,
    hash_bits.
    """
    F1, F2 = 1 << b1, 1 << b2
    nchunks = s_part1.numel() // (chunk_rows * LANES)
    st = host_read(starts1.reshape(nchunks, -1)[:, :F1 + 1].long())
    runs1 = st[:, 1:] - st[:, :-1]
    buckets = runs1.sum(0)
    c1_rows = (-(-int(runs1.max()) // LANES) + 1 + 7) & ~7
    if max_chunks is not None:
        if c1_rows > chunk_rows or nchunks > max_chunks \
                or nchunks * c1_rows > GATHER_BUDGET_ROWS:
            return None
    elif int(buckets.max()) > 2 * int(buckets.sum()) // F1 \
            + chunk_rows * LANES:
        return None
    c1_rows = min(c1_rows, chunk_rows)
    cap_rows = (-(-(int(buckets.max()) + nchunks * LANES) // LANES)
                + 7) & ~7
    cap_rows = min(cap_rows, nchunks * c1_rows)
    cat2_rows = ((F2 + 1 + LANES - 1) // LANES + 7) & ~7
    return Pass2Geom(b1=b1, b2=b2, chunk_rows=chunk_rows, nchunks=nchunks,
                     c1_rows=c1_rows, cap_rows=cap_rows, cat2_rows=cat2_rows,
                     **{"shift1": 0, "shift2": 0, "lo": 0, "hi": 0, **mode})


@dataclasses.dataclass
class TwoPassPlan:
    """A planned two-pass radix join over device-resident, chunk-padded
    inputs: R partition -> bitmap build (both at the full probe geometry)
    -> S pass 1 -> S pass 2 -> bitmap probe of the regions.

    full() runs the whole join and returns the count as a device tensor
    without synchronising; full_count() reads it back; phase_fns() gives
    one callable per phase; spans and run() as RadixJoinPlan's.
    """

    rk_in: torch.Tensor
    sk_in: torch.Tensor
    lo: int
    hi: int
    rgeom: radix_ops.RadixGeom       # R partition, the probe's fan-out
    p1geom: radix_ops.RadixGeom      # S pass 1
    pass2: Pass2Geom
    part_bits: int
    shift: int
    sl_rows: int
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.sk_in.device

    def r_partition(self):
        with span("hbrj.r_partition"):
            return radix_ops.partition_pass(self.rk_in, self.rgeom)

    def build(self, r_part: torch.Tensor,
              starts: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("hbrj.build"):
            return bitmap_join.bitmap_build(r_part, self.lo, self.hi,
                                            self.part_bits, self.shift,
                                            self.sl_rows, starts)

    def s_partition(self):
        with span("hbrj.s_partition"):
            return radix_ops.partition_pass(self.sk_in, self.p1geom)

    def s_pass2(self, s1):
        """(regions, starts2) of S's pass 2."""
        with span("hbrj.s_pass2"):
            return pass2_partition(s1[0], s1[1], self.pass2)

    def probe(self, bitmap: torch.Tensor, s2):
        with span("hbrj.probe"):
            return bitmap_join.bitmap_probe_count(
                bitmap, s2[0], self.lo, self.shift, self.part_bits,
                self.sl_rows, s2[1], seg_bits=self.pass2.b2)

    def run(self) -> torch.Tensor:
        bitmap = self.build(*self.r_partition())
        return self.probe(bitmap, self.s_pass2(self.s_partition()))

    def full(self) -> torch.Tensor:
        with span("hbrj.full"):
            return self.run()

    def full_count(self) -> int:
        return host_read(self.full())

    def _intermediates(self) -> dict:
        if not self._cache:
            r_part, r_starts = self.r_partition()
            s1 = self.s_partition()
            self._cache.update(r_part=r_part, r_starts=r_starts,
                               bitmap=self.build(r_part, r_starts),
                               s1=s1, s2=self.s_pass2(s1))
        return self._cache

    def phase_fns(self) -> dict:
        """name -> zero-argument callable re-running that phase, join order."""
        m = self._intermediates()
        return {"r_partition": self.r_partition,
                "build": lambda: self.build(m["r_part"], m["r_starts"]),
                "s_partition": self.s_partition,
                "s_pass2": lambda: self.s_pass2(m["s1"]),
                "probe": lambda: self.probe(m["bitmap"], m["s2"])}


def plan_radix_join_2pass(r_key, s_key, lo: int, hi: int, device="cuda",
                          chunk_rows: int = bitmap_join.CHUNK_ROWS,
                          num_radix_bits: Optional[int] = None):
    """Two-pass plan: partition by the high bits, regroup contiguous, probe.

    Same contract as plan_radix_join (unique R in [lo, hi]; numpy or tensor
    inputs; the card unless the caller asks for the CPU).  Returns None
    where the JAX package's planner does: fewer than 2 partition bits, a
    pass-1 run (nearly) filling a chunk, or a TPU gather buffer or chunk
    count past its limits (one host sync reads pass 1's starts).
    """
    device = torch.device(device)
    part_bits, shift, sl_rows = bitmap_join.plan_geometry(lo, hi,
                                                          num_radix_bits)
    if part_bits < 2:
        return None
    b1, b2 = RadixConfig(passes=2).split_bits(part_bits)
    p1geom = radix_ops.RadixGeom(chunk_rows=chunk_rows, part_bits=b1, lo=lo,
                                 hi=hi, shift=shift + b2)
    with span("hbrj.plan.pad_s"):
        sk_in = radix_ops._chunk_pad(s_key, chunk_rows * LANES, device)
    with span("hbrj.plan.pass2_geometry"):
        s1, starts1 = radix_ops.partition_pass(sk_in, p1geom)
        p2 = plan_pass2(s1, starts1, b1, b2, chunk_rows, MAX_RANGE_CHUNKS,
                        lo=lo, hi=hi, shift1=shift + b2, shift2=shift)
    if p2 is None:
        return None
    rk_in, rgeom = bitmap_join.plan_bitmap_build(r_key, lo, hi, part_bits,
                                                 shift, sl_rows, chunk_rows,
                                                 device)
    return TwoPassPlan(rk_in=rk_in, sk_in=sk_in, lo=lo, hi=hi, rgeom=rgeom,
                       p1geom=p1geom, pass2=p2, part_bits=part_bits,
                       shift=shift, sl_rows=sl_rows)
