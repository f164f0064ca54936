"""Radix partition and survivor compaction over (rows, 128) int32 key tiles.

Counterpart of ``hwbloomradixjoin_tpu/ops/radix.py``.  Keys stream in chunks
of ``chunk_rows * 128``; each chunk is reordered bucket-major, stably, and a
suffix-filled ``starts`` table gives each category's run.  The layouts are
the JAX package's, bit for bit:

- keys out: ``(nchunks * chunk_rows, 128)`` int32, chunk-major;
- starts: ``(nchunks * cat_rows, 128)`` int32; flat entry j of a chunk is the
  number of its elements with category < j (so ``chunk`` past the last
  category); ``cat_rows`` is rounded up to a multiple of 8.

``partition_pass``, ``partition_pass_kv`` (the same pass moving a payload
column with the keys) and ``compact_pass`` launch the hand-written CUDA
kernels of ``csrc/radix.cu`` for a tensor on the card and run their plain
PyTorch twins (``*_plain``) for a tensor on the CPU.  The twins are the
reference the kernels are checked against on the card.

A geometry partitions by key range, or, with ``hash_seed`` set, by the top
bits of the bloom filter's block index (hash mode, ``ops/bloom_pallas.py``).

``radix_join_count`` is the general radix count join of the JAX package's
``radix_join_count_pallas``: both sides partitioned by the low 12 bits, then
``gathered_probe_count`` (``csrc/gathered_probe.cu``) counts each bucket's
matches with multiplicity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import hashes
from hwbloomradixjoin_tpu_torch.types import PAD_KEY

LANES = 128
# The most R keys a bucket of the gathered probe may hold: the JAX package's
# default R_SEGS * SEG_ROWS * 128 = 40,960, so the port probes every input
# the JAX probe takes (the kernel sizes each bucket's hash table to the
# bucket, not to this cap).
R_CAP = 40 * 8 * LANES


@dataclasses.dataclass(frozen=True)
class RadixGeom:
    """Static partition geometry.

    Range mode: bucket of a key = ((key - lo) >>> shift) & (2^part_bits -
    1), a logical shift of the int32-wrapped difference.  With pad_cat, PAD
    keys and keys outside [lo, hi] (when hi is set) take the pad category
    2^part_bits and sort to the chunk tail; without it (safe only when
    pad_cat_safe(lo, hi) and the stream has no real out-of-range keys) PAD
    lands in a junk bucket and consumers mask by bucket-of-key.

    Hash mode (hash_seed set): bucket = (crc32c(hash_seed, key) &
    (2^hash_bits - 1)) >> (hash_bits - part_bits), the top part_bits bits of
    the key's filter block; PAD takes the pad category.  lo, hi and shift
    are unused.
    """

    chunk_rows: int = 1024
    part_bits: int = 12
    lo: int = 0
    hi: Optional[int] = None
    shift: int = 0
    pad_cat: bool = True
    hash_seed: Optional[int] = None
    hash_bits: int = 0

    def __post_init__(self):
        if self.hash_seed is not None and not (
                0 <= self.part_bits <= self.hash_bits <= 31 and self.pad_cat):
            raise ValueError(f"hash mode needs 0 <= part_bits "
                             f"{self.part_bits} <= hash_bits {self.hash_bits}"
                             f" <= 31 and the pad category")
        if not 0 <= self.shift <= 31:
            raise ValueError(f"shift {self.shift} outside [0, 31]")

    @property
    def cat_rows(self) -> int:
        cr = ((1 << self.part_bits) + 1 + LANES - 1) // LANES
        return (cr + 7) & ~7

    @property
    def ncats(self) -> int:
        return (1 << self.part_bits) + (1 if self.pad_cat else 0)


def pad_cat_safe(lo: int, hi: int) -> bool:
    """True iff PAD_KEY's wrapped norm can never alias a real bucket.

    norm(PAD) = PAD_KEY - lo wraps (int32) to 2^31 - lo; its bucket test
    (norm >> shift) == b fails for every b < F iff 2^31 - lo >= 2^range_bits.
    """
    span = hi - lo + 1
    range_bits = max((max(span - 1, 1)).bit_length(), 12)
    return 0 <= lo <= (1 << 31) - (1 << range_bits) and range_bits <= 30


def geom_cat_fn(geom: RadixGeom):
    """bucket-of-key category function of a geometry (int64 result)."""
    def cat_fn(key: torch.Tensor) -> torch.Tensor:
        if geom.hash_seed is not None:
            block = hashes.hash_crc(geom.hash_seed, key) \
                & ((1 << geom.hash_bits) - 1)
            return torch.where(key != PAD_KEY,
                               block >> (geom.hash_bits - geom.part_bits),
                               1 << geom.part_bits)
        norm = (key.long() - geom.lo) & 0xFFFFFFFF     # uint32 wrap
        bucket = (norm >> geom.shift) & ((1 << geom.part_bits) - 1)
        if not geom.pad_cat:
            return bucket
        valid = key != PAD_KEY
        if geom.hi is not None:
            valid = valid & (key >= geom.lo) & (key <= geom.hi)
        return torch.where(valid, bucket, 1 << geom.part_bits)
    return cat_fn


def _chunk_pad(keys, chunk_elems: int, device="cuda") -> torch.Tensor:
    """Flat int32 keys padded with PAD_KEY to a chunk multiple (>= 1 chunk),
    on `device` (the card unless the caller asks for the CPU).

    numpy input is padded on the host before the one copy to `device`, so a
    large S never has two copies on the card.
    """
    n = keys.shape[0]
    padded = -(-max(n, 1) // chunk_elems) * chunk_elems
    if isinstance(keys, np.ndarray):
        host = np.ascontiguousarray(keys, dtype=np.int32)
        if padded != n:
            host = np.concatenate([host, np.full(padded - n, PAD_KEY, np.int32)])
        return torch.from_numpy(host).to(device)
    keys = keys.to(device=device, dtype=torch.int32)
    if padded == n:
        return keys.contiguous()
    return torch.cat([keys, keys.new_full((padded - n,), PAD_KEY)])


def _nchunks(keys_flat: torch.Tensor, chunk_rows: int) -> int:
    chunk = chunk_rows * LANES
    if keys_flat.dim() != 1 or keys_flat.numel() % chunk:
        raise ValueError(f"need flat keys in whole chunks of {chunk}, got "
                         f"shape {tuple(keys_flat.shape)}")
    return keys_flat.numel() // chunk


def _sort_chunks(keys_flat: torch.Tensor, geom: RadixGeom):
    """Per-chunk stable sort by category: (order, starts) of the plain twins."""
    nchunks = _nchunks(keys_flat, geom.chunk_rows)
    keys = keys_flat.view(nchunks, geom.chunk_rows * LANES)
    cat_sorted, order = torch.sort(geom_cat_fn(geom)(keys), dim=1, stable=True)
    j = torch.arange(geom.cat_rows * LANES, device=keys.device)
    starts = torch.searchsorted(cat_sorted, j.expand(nchunks, -1).contiguous())
    return order, starts.to(torch.int32).view(nchunks * geom.cat_rows, LANES)


def _permute(col_flat: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.gather(col_flat.view(order.shape), 1, order).view(-1, LANES)


def partition_pass_plain(keys_flat: torch.Tensor, geom: RadixGeom):
    """Plain twin of partition_pass: per-chunk stable sort by category."""
    order, starts = _sort_chunks(keys_flat, geom)
    return _permute(keys_flat, order), starts


def partition_pass_kv_plain(keys_flat: torch.Tensor, pays_flat: torch.Tensor,
                            geom: RadixGeom):
    """Plain twin of partition_pass_kv: the payloads follow the keys' order."""
    order, starts = _sort_chunks(keys_flat, geom)
    return _permute(keys_flat, order), _permute(pays_flat, order), starts


def _partition_launch(keys_flat: torch.Tensor, pays_flat, geom: RadixGeom):
    """Launch hbrj_partition (with a payload column when pays_flat is set).

    The kernel sizes its own scratch (hbrj_partition_scratch): one
    histogram of at most 257 words per 4,096-key tile and, past one sweep,
    a column of the input's size for each of keys, payloads and (hash mode)
    categories, at any fan-out.
    """
    nchunks = _nchunks(keys_flat, geom.chunk_rows)
    chunk = geom.chunk_rows * LANES
    dev = keys_flat.device
    hashed = geom.hash_seed is not None
    out = torch.empty((nchunks * geom.chunk_rows, LANES), dtype=torch.int32,
                      device=dev)
    starts = torch.empty((nchunks * geom.cat_rows, LANES), dtype=torch.int32,
                         device=dev)
    pays_out = None if pays_flat is None else torch.empty_like(out)
    words = _build.lib().hbrj_partition_scratch(
        nchunks, chunk, geom.part_bits, int(geom.pad_cat), int(hashed),
        int(pays_flat is not None))
    scratch = torch.empty(max(words, 4), dtype=torch.int32, device=dev)
    if pays_flat is not None:
        name = "partition_kv"
    else:
        name = "partition_hash" if hashed else "partition"
    _build.launch(name, "hbrj_partition", dev, keys_flat.data_ptr(),
                  None if pays_flat is None else pays_flat.data_ptr(),
                  out.data_ptr(),
                  None if pays_out is None else pays_out.data_ptr(),
                  starts.data_ptr(), scratch.data_ptr(), nchunks, chunk,
                  geom.lo, geom.hi if geom.hi is not None else 0,
                  int(geom.hi is not None), geom.shift, geom.part_bits,
                  int(geom.pad_cat), geom.cat_rows * LANES, int(hashed),
                  (geom.hash_seed or 0) & 0xFFFFFFFF, geom.hash_bits)
    return out, pays_out, starts


def partition_pass(keys_flat: torch.Tensor, geom: RadixGeom):
    """One radix pass: chunk-major, bucket-major keys + per-chunk starts.

    keys_flat: (n,) int32, n a multiple of chunk_rows*128 (PAD_KEY padded).
    Any part_bits the JAX planners return (up to 19 on the bitmap engine,
    21 on the count tables) runs in one pass.  Returns (keys_out
    (nchunks*chunk_rows, 128), starts (nchunks*cat_rows, 128)).  Replaces
    the Pallas partition_pass (radix.py:460).
    """
    _nchunks(keys_flat, geom.chunk_rows)
    if keys_flat.device.type == "cpu":
        return partition_pass_plain(keys_flat, geom)
    _build.check_cuda(keys_flat)
    out, _, starts = _partition_launch(keys_flat, None, geom)
    return out, starts


def partition_pass_kv(keys_flat: torch.Tensor, pays_flat: torch.Tensor,
                      geom: RadixGeom):
    """partition_pass moving a payload column by the keys' permutation.

    pays_flat: (n,) int32 beside keys_flat.  Returns (keys_out, pays_out,
    starts); keys_out and starts equal partition_pass's.  Replaces the
    Pallas partition_pass_kv (radix.py:499).
    """
    _nchunks(keys_flat, geom.chunk_rows)
    if pays_flat.shape != keys_flat.shape:
        raise ValueError(f"payloads {tuple(pays_flat.shape)} beside keys "
                         f"{tuple(keys_flat.shape)}")
    if keys_flat.device.type == "cpu":
        return partition_pass_kv_plain(keys_flat, pays_flat, geom)
    _build.check_cuda(keys_flat, pays_flat)
    return _partition_launch(keys_flat, pays_flat, geom)


def _valid_keys(part: torch.Tensor, starts: torch.Tensor, geom: RadixGeom):
    """The keys of a partitioned stream outside the pad category."""
    nchunks = _nchunks(part.reshape(-1), geom.chunk_rows)
    keys = part.reshape(nchunks, -1)
    end = starts.reshape(nchunks, -1)[:, 1 << geom.part_bits]
    return keys[torch.arange(keys.shape[1], device=keys.device) < end[:, None]]


def gathered_probe_count_plain(r_part, r_starts, s_part, s_starts,
                               geom: RadixGeom):
    """Plain twin of gathered_probe_count: int64 (count, overflow).

    A sort of R's keys and two searchsorteds of S's give each S key its
    key's multiplicity in R; S keys of a bucket whose R holds more than
    R_CAP keys are not counted, and such a bucket sets overflow (1).
    """
    cat = geom_cat_fn(geom)
    rk, sk = _valid_keys(r_part, r_starts, geom), _valid_keys(s_part,
                                                              s_starts, geom)
    r_sorted = torch.sort(rk).values
    mult = torch.searchsorted(r_sorted, sk, right=True) \
        - torch.searchsorted(r_sorted, sk)
    r_per_bucket = torch.bincount(cat(rk), minlength=1 << geom.part_bits)
    probed = r_per_bucket[cat(sk)] <= R_CAP
    return torch.stack([(mult * probed).sum(),
                        (r_per_bucket > R_CAP).any().long()])


def _check_probe_geom(geom: RadixGeom) -> None:
    if geom.hash_seed is not None or not geom.pad_cat:
        raise ValueError("the gathered probe takes range-mode partitions "
                         "with the pad category")


def gathered_probe_count(r_part: torch.Tensor, r_starts: torch.Tensor,
                         s_part: torch.Tensor, s_starts: torch.Tensor,
                         geom: RadixGeom) -> torch.Tensor:
    """Count the key matches of R and S partitioned by partition_pass(geom).

    Returns a (2,) int64 tensor on their device: the number of matching
    (r, s) pairs, and 1 when a bucket's R holds more than R_CAP keys (that
    bucket is then not counted; the caller must use another path), else 0.
    Replaces the Pallas gathered_probe_count (radix.py:657); the kernel reads
    each bucket's runs through the starts tables, so the TPU's gather
    descriptors (build_gather_descriptors, group_descriptors) have no
    counterpart.  It chooses each bucket's table size on the card: no host
    read.
    """
    _check_probe_geom(geom)
    if s_part.device.type == "cpu":
        return gathered_probe_count_plain(r_part, r_starts, s_part, s_starts,
                                          geom)
    _build.check_cuda(r_part, r_starts, s_part, s_starts)
    chunk = geom.chunk_rows * LANES
    out = torch.empty(2, dtype=torch.int64, device=s_part.device)
    scratch = torch.empty(
        _build.lib().hbrj_gathered_probe_scratch(geom.part_bits, R_CAP),
        dtype=torch.int32, device=s_part.device)
    _build.launch("gathered_probe", "hbrj_gathered_probe", s_part.device,
                  r_part.data_ptr(), r_starts.data_ptr(),
                  _nchunks(r_part.reshape(-1), geom.chunk_rows),
                  s_part.data_ptr(), s_starts.data_ptr(),
                  _nchunks(s_part.reshape(-1), geom.chunk_rows), chunk,
                  geom.cat_rows * LANES, geom.part_bits, R_CAP,
                  scratch.data_ptr(), out.data_ptr())
    return out


def radix_join_count(r_keys, s_keys, geom: Optional[RadixGeom] = None,
                     device="cuda"):
    """General radix join, count only: returns (count, overflow).

    Both sides are partitioned by kernel 1 with geom (default: the JAX
    package's DEFAULT_GEOM, the reference's low-bit radix over 12 bits),
    then each bucket is probed by gathered_probe_count.  overflow True
    means a bucket's R exceeded R_CAP keys (heavy key skew): the count is
    then 0 and the caller must use a portable path, as with the JAX
    package's radix_join_count_pallas.  Inputs: numpy arrays or tensors;
    device: where the join runs, the card unless the caller asks for the
    CPU.
    """
    geom = geom or RadixGeom()
    _check_probe_geom(geom)
    chunk = geom.chunk_rows * LANES
    r2, r_starts = partition_pass(_chunk_pad(r_keys, chunk, device), geom)
    s2, s_starts = partition_pass(_chunk_pad(s_keys, chunk, device), geom)
    count, overflow = gathered_probe_count(r2, r_starts, s2, s_starts,
                                           geom).tolist()
    if overflow:
        return 0, True
    return count, False


def _compact_cap(chunk_rows: int, cap_rows: Optional[int]) -> int:
    cap = chunk_rows if cap_rows is None else cap_rows
    if not (8 <= cap <= chunk_rows and cap % 8 == 0):
        raise ValueError(f"cap_rows {cap} not a multiple of 8 in "
                         f"[8, {chunk_rows}]")
    return cap


def compact_pass_plain(keys_flat: torch.Tensor, lo: int, hi: int,
                       chunk_rows: int, cap_rows: Optional[int] = None):
    """Plain twin of compact_pass: per-chunk stable live-first sort."""
    nchunks = _nchunks(keys_flat, chunk_rows)
    cap = _compact_cap(chunk_rows, cap_rows)
    keys = keys_flat.view(nchunks, chunk_rows * LANES)
    live = (keys >= lo) & (keys <= hi)
    order = torch.sort((~live).to(torch.int32), dim=1, stable=True).indices
    packed = torch.gather(keys, 1, order)[:, :cap * LANES]
    nlive = live.sum(dim=1, keepdim=True)
    pos = torch.arange(cap * LANES, device=keys.device)
    out = torch.where(pos < nlive, packed, PAD_KEY)
    counts = nlive.to(torch.int32).expand(nchunks, 8 * LANES)
    return (out.view(nchunks * cap, LANES),
            counts.reshape(nchunks * 8, LANES))


def compact_pass(keys_flat: torch.Tensor, lo: int, hi: int, chunk_rows: int,
                 cap_rows: Optional[int] = None):
    """Live/dead compaction: each chunk's keys in [lo, hi] move to its head.

    cap_rows truncates each chunk's output to its first cap_rows rows.
    Returns (out (nchunks*cap_rows, 128), counts (nchunks*8, 128)) with all
    8*128 words of chunk c's count block = live count of chunk c.  Replaces
    the Pallas compact_pass (radix.py:297).
    """
    nchunks = _nchunks(keys_flat, chunk_rows)
    cap = _compact_cap(chunk_rows, cap_rows)
    if keys_flat.device.type == "cpu":
        return compact_pass_plain(keys_flat, lo, hi, chunk_rows, cap_rows)
    _build.check_cuda(keys_flat)
    dev = keys_flat.device
    out = torch.empty((nchunks * cap, LANES), dtype=torch.int32, device=dev)
    counts = torch.empty((nchunks * 8, LANES), dtype=torch.int32, device=dev)
    _build.launch("compact", "hbrj_compact", dev, keys_flat.data_ptr(),
                  out.data_ptr(), counts.data_ptr(), nchunks,
                  chunk_rows * LANES, cap * LANES, lo, hi)
    return out, counts
