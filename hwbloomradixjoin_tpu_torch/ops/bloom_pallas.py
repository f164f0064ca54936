"""The blocked-bloom prune: hash partition of S, then the filter probe.

Counterpart of ``hwbloomradixjoin_tpu/ops/bloom_pallas.py`` (the module
keeps the JAX name so the two are easy to pair).  The thesis's blocked
filter confines a key's k probes to one B-bit block
(bloom_filter.c:125-141); the prune partitions S by the top bits of the
block index crc32c(seed, key) (``radix.partition_pass`` in hash mode, one
pass up to MAX_PART_BITS bits, else two with ``multipass.pass2_partition``)
so that neighbouring keys probe one 2^17-bit slice of the filter, then
``bloom_probe_prune`` keeps each key the filter contains and writes PAD in
place of the rest.  The pruned stream feeds the join planners directly:
they accept any order and drop PAD.

``bloom_probe_prune`` launches the CUDA kernel of ``csrc/bloom.cu`` for a
tensor on the card and runs its plain twin ``bloom_probe_prune_plain`` for a
tensor on the CPU.  The TPU kernel held one bucket's slice in VMEM and read
its runs through window and ownership descriptors; the port's kernel takes
the partition's ``starts`` (pass 1's chunks, or pass 2's regions) and walks
each bucket range's runs with the range's filter slices in shared memory
(``ops/run_split.py``); without starts (S as it comes), or where one
bucket's slice passes the staging budget, it streams the keys flat against
the filter in device memory.  Either way each key is read, and each
survivor emitted, once, at the position it arrived.  The contract is the
JAX package's: the multiset of survivors and their exact count (the JAX
output's shape follows its windows; the port's is its input's).

The planner takes the JAX package's partition geometry but none of its TPU
limits (Mosaic's 8-row slices, pass 2's gather budget and chunk cap, a run
filling a chunk), under which the JAX package prunes in plain XLA: the
port's kernels read the filter flat and each run in place, so every blocked
filter prunes through them.  A block larger than a slice is partitioned by
whole blocks, and a skewed S, whose pass-2 regions would multiply its size,
is probed in pass 1's order.  The basic variant spreads its probes over the
whole filter and has no probe kernel; it prunes in plain torch behind the
build kernel (``models/bloom_join.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import bitmap_join, bloom, multipass
from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops
from hwbloomradixjoin_tpu_torch.ops import run_split
from hwbloomradixjoin_tpu_torch.ops.radix import LANES
from hwbloomradixjoin_tpu_torch.types import PAD_KEY
from hwbloomradixjoin_tpu_torch.utils.profiling import host_read, span

SLICE_BITS = 17            # 2^17-bit slices (32 rows of 128 words)
MAX_PART_BITS = 10         # one hash pass up to this depth
MAX_PART_BITS_2PASS = 20   # 2-pass depth cap (m <= 2^37 at B = 512)
# The probe kernel's staging: 512 threads a CTA, 8 keys a lane in flight,
# at most 128 KiB of filter slices (beside its 4 KiB of crc32c tables);
# past it, the flat class.
PROBE_THREADS = 512
PROBE_LANE_KEYS = 8
PROBE_MAX_STAGE = 128 * 1024


def geometry_raw(args: BloomArgs):
    """(part_bits, hash_bits) for slice-local probing; None if the variant
    or geometry has none at any partition depth."""
    if args.variant != BloomVariant.BLOCKED:
        return None
    hash_bits = (args.nblocks - 1).bit_length() if args.nblocks > 1 else 0
    b_bits = (args.B - 1).bit_length()
    if b_bits > SLICE_BITS:
        return None    # a block larger than a slice (JAX: the plain prune)
    part_bits = max(hash_bits - (SLICE_BITS - b_bits), 0)
    if part_bits > hash_bits or part_bits > MAX_PART_BITS_2PASS:
        return None
    return part_bits, hash_bits


def geometry(args: BloomArgs):
    """(part_bits, hash_bits) for the single-pass prune; None if deeper
    (the flagship m = 2^30, B = 512 needs 13 bits: two passes)."""
    g = geometry_raw(args)
    if g is None or g[0] > MAX_PART_BITS:
        return None
    return g


def _prune_out(keys: torch.Tensor, out: Optional[torch.Tensor]):
    if out is None:
        return torch.empty_like(keys)
    if out.dim() != 1 or out.numel() < keys.numel() \
            or out.dtype != torch.int32 or out.device != keys.device:
        raise ValueError(f"output of {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} for {keys.numel()} keys")
    return out


def bloom_probe_prune_plain(filter_words: torch.Tensor, s_part: torch.Tensor,
                            args: BloomArgs,
                            out: Optional[torch.Tensor] = None):
    """Plain twin of bloom_probe_prune: the global-position test of
    bloom.probe_bitmap as a mask, and a where."""
    keys = s_part.reshape(-1)
    out = _prune_out(keys, out)
    keep = bloom.probe_bitmap(filter_words, keys, args) & (keys != PAD_KEY)
    torch.where(keep, keys, keys.new_tensor(PAD_KEY),
                out=out[:keys.numel()])
    return out, keep.sum()


def probe_split(keys: torch.Tensor, args: BloomArgs,
                starts: Optional[torch.Tensor] = None,
                part_bits: Optional[int] = None,
                seg_bits: Optional[int] = None,
                sms: int = run_split.H100_SMS):
    """The probe kernel's split of hash-partitioned keys
    (run_split.plan_split), or None for the flat class: no starts, or one
    bucket's filter slice (m / 32 / 2^part_bits words) past
    PROBE_MAX_STAGE or under one 16-byte copy.

    part_bits: the bits of the partition's buckets (the top part_bits of the
    block index); seg_bits: those of a segment, part_bits for partition
    chunks (None), b2 for pass-2 regions; raises on starts of the wrong
    size."""
    if starts is None:
        return None
    hash_bits = (args.nblocks - 1).bit_length()
    if part_bits is None or not 0 <= part_bits <= hash_bits:
        raise ValueError(f"starts need the partition's bits (0 to "
                         f"{hash_bits}), got {part_bits}")
    seg_bits = part_bits if seg_bits is None else seg_bits
    runs = run_split.segment_runs(starts, keys, seg_bits, part_bits)
    words = slice_words(args, part_bits)
    if words < 4:
        return None
    return run_split.plan_split(runs, seg_bits, seg_bits < part_bits,
                                4 * words, PROBE_MAX_STAGE, PROBE_THREADS,
                                PROBE_LANE_KEYS, sms)


def slice_words(args: BloomArgs, part_bits: int) -> int:
    """Filter words of one bucket of a part_bits hash partition."""
    return (args.m // 32) >> part_bits


def bloom_probe_prune(filter_words: torch.Tensor, s_part: torch.Tensor,
                      args: BloomArgs, out: Optional[torch.Tensor] = None,
                      starts: Optional[torch.Tensor] = None,
                      part_bits: Optional[int] = None,
                      seg_bits: Optional[int] = None):
    """Prune hash-partitioned S against a blocked filter.

    filter_words: the filter's m/32 int32 words (bloom.build_bitmap);
    s_part: S keys, any shape, a multiple of 4 keys.  Writes each key the
    filter contains, PAD in place of every other key (PAD included), to the
    first s_part.numel() words of `out` (flat int32; allocated when None,
    words past them untouched).  starts, part_bits, seg_bits: the hash
    partition S comes in (partition_pass's starts at part_bits, or
    pass2_partition's starts2 with part_bits = b1 + b2 and seg_bits = b2):
    the kernel walks each bucket range's runs, and writes the pad runs and
    region tails, which hold only PAD, as PAD unread.  Without them it
    streams S flat; the CPU twin checks their size and ignores them.
    Returns (out, survivor count as a 0-d int64 tensor).  Replaces the
    Pallas bloom_probe_prune (bloom_pallas.py:182).
    """
    if args.variant != BloomVariant.BLOCKED:
        raise ValueError("the bloom probe kernel serves the blocked variant")
    if filter_words.numel() != args.m // 32:
        raise ValueError(f"filter of {filter_words.numel()} words for "
                         f"m = {args.m}")
    keys = s_part.reshape(-1)
    if keys.numel() % 4:
        raise ValueError(f"{keys.numel()} keys: need a multiple of 4")
    out = _prune_out(keys, out)
    if keys.device.type == "cpu":
        probe_split(keys, args, starts, part_bits, seg_bits)
        return bloom_probe_prune_plain(filter_words, keys, args, out)
    _build.check_cuda(filter_words, keys, out,
                      *(() if starts is None else (starts,)))
    split = probe_split(keys, args, starts, part_bits, seg_bits,
                        run_split.card_sms(keys.device))
    grid = (0,) * 8 if split is None else split.args()
    count = torch.zeros((), dtype=torch.int64, device=keys.device)
    _build.launch("bloom_probe", "hbrj_bloom_probe", keys.device,
                  keys.data_ptr(), keys.numel(),
                  0 if starts is None else starts.data_ptr(),
                  filter_words.data_ptr(), out.data_ptr(), count.data_ptr(),
                  args.seed & 0xFFFFFFFF, args.nblocks, args.B, args.k, *grid,
                  0 if split is None else slice_words(args, part_bits))
    return out, count


@dataclasses.dataclass
class BloomPrunePlan:
    """The prune over device-resident inputs: filter build from R
    (bloom.build_bitmap), hash partition of S (one or two passes), filter
    probe.

    prune() rebuilds the filter, re-partitions S and writes the pruned keys
    into `out` IN PLACE (a join plan planned over `out` reads them there),
    returning (out, survivor count); its layout is the same on every call.
    s_after is the survivor count of the planning run.  phase_fns() gives
    bloom_build, bloom_partition and bloom_probe, each re-run on the planned
    inputs; each phase runs in its span (``hbrj.bloom_build``, ...).
    """

    r_key: torch.Tensor
    sk_in: torch.Tensor
    args: BloomArgs
    pgeom: radix_ops.RadixGeom       # pass 1 (hash mode)
    pass2: Optional[multipass.Pass2Geom]
    out: torch.Tensor                # chunk-padded, PAD past the pruned keys
    s_after: int = -1
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def build(self) -> torch.Tensor:
        with span("hbrj.bloom_build"):
            return bloom.build_bitmap(self.r_key, self.args)

    def partition(self):
        """(keys, starts) of hash-partitioned S: pass 1's, or pass 2's
        regions and starts2."""
        with span("hbrj.bloom_partition"):
            s1 = radix_ops.partition_pass(self.sk_in, self.pgeom)
            if self.pass2 is None:
                return s1
            return multipass.pass2_partition(*s1, self.pass2)

    def probe(self, words: torch.Tensor, s_part):
        b2 = None if self.pass2 is None else self.pass2.b2
        with span("hbrj.bloom_probe"):
            return bloom_probe_prune(words, s_part[0], self.args,
                                     out=self.out, starts=s_part[1],
                                     part_bits=self.pgeom.part_bits
                                     + (b2 or 0), seg_bits=b2)

    def prune(self):
        return self.probe(self.build(), self.partition())

    def phase_fns(self) -> dict:
        if not self._cache:
            self._cache.update(words=self.build(), s_part=self.partition())
        m = self._cache
        return {"bloom_build": self.build,
                "bloom_partition": self.partition,
                "bloom_probe": lambda: self.probe(m["words"], m["s_part"])}


def _partition_bits(args: BloomArgs):
    """(part_bits, hash_bits) of the port's prune of a blocked filter: the
    JAX geometry where it has one, else the block index's bits up to
    MAX_PART_BITS_2PASS (a block past a slice: whole blocks)."""
    g = geometry_raw(args)
    if g is not None:
        return g
    hash_bits = (args.nblocks - 1).bit_length()
    return min(hash_bits, MAX_PART_BITS_2PASS), hash_bits


def _plan(r_key, sk_in, args, pgeom, pass2, n_out, chunk) -> BloomPrunePlan:
    with span("hbrj.plan.prune_out"):
        out = sk_in.new_full((-(-n_out // chunk) * chunk,), PAD_KEY)
    r = r_key if isinstance(r_key, torch.Tensor) else torch.from_numpy(r_key)
    plan = BloomPrunePlan(r_key=r.to(sk_in.device), sk_in=sk_in, args=args,
                          pgeom=pgeom, pass2=pass2, out=out)
    with span("hbrj.plan.prune"):
        plan.s_after = host_read(plan.prune()[1])
    return plan


def plan_bloom_prune(r_key, s_key, args: BloomArgs, device="cuda",
                     chunk_rows: int = bitmap_join.CHUNK_ROWS):
    """Plan the prune of S by R's filter, and run it once.

    r_key/s_key: numpy arrays or tensors; device: where it runs, the card
    unless the caller asks for the CPU.  One hash pass up to MAX_PART_BITS
    partition bits, else two.  Returns None for the basic variant only (the
    plain prune).  `out` is padded to whole chunks of chunk_rows.
    """
    if args.variant != BloomVariant.BLOCKED:
        return None
    part_bits, hash_bits = _partition_bits(args)
    if part_bits > MAX_PART_BITS:
        return plan_bloom_prune_2pass(r_key, s_key, args, part_bits,
                                      hash_bits, device=device,
                                      chunk_rows=chunk_rows)
    chunk = chunk_rows * LANES
    with span("hbrj.plan.pad_s"):
        sk_in = radix_ops._chunk_pad(s_key, chunk, torch.device(device))
    pgeom = radix_ops.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits,
                                hash_seed=args.seed, hash_bits=hash_bits)
    return _plan(r_key, sk_in, args, pgeom, None, sk_in.numel(), chunk)


def plan_bloom_prune_2pass(r_key, s_key, args: BloomArgs, part_bits: int,
                           hash_bits: int, device="cuda",
                           chunk_rows: int = bitmap_join.CHUNK_ROWS):
    """The deep-geometry prune: pass 1 by the top b1 = min(part_bits - 1,
    MAX_PART_BITS) block bits, pass 2 regrouping each bucket by the next
    b2, then the probe over the regions (the reference's two-pass
    choreography with the filter fused into S's pass,
    parallel_radix_join_bloom.c:798-849, 1851-1889).  Pass 1's starts are
    read back once; where they show a skewed S (multipass.plan_pass2's
    None), the probe reads pass 1's output and pass 2 is left out."""
    if part_bits < 2:
        raise ValueError(f"{part_bits} partition bits: two passes need 2")
    b1 = min(part_bits - 1, MAX_PART_BITS)
    b2 = part_bits - b1
    chunk = chunk_rows * LANES
    with span("hbrj.plan.pad_s"):
        sk_in = radix_ops._chunk_pad(s_key, chunk, torch.device(device))
    p1geom = radix_ops.RadixGeom(chunk_rows=chunk_rows, part_bits=b1,
                                 hash_seed=args.seed, hash_bits=hash_bits)
    with span("hbrj.plan.pass2_geometry"):
        s1, starts1 = radix_ops.partition_pass(sk_in, p1geom)
        p2 = multipass.plan_pass2(s1, starts1, b1, b2, chunk_rows, None,
                                  hash_seed=args.seed, hash_bits=hash_bits)
        del s1, starts1
    n_out = sk_in.numel() if p2 is None else (1 << b1) * p2.cap_rows * LANES
    return _plan(r_key, sk_in, args, p1geom, p2, n_out, chunk)
