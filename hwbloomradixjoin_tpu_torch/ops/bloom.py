"""Bloom filter math, bit-exact with the reference, on torch tensors.

Counterpart of ``hwbloomradixjoin_tpu/ops/bloom.py`` (src/bloom_filter.c):

- probe sequence: enhanced double hashing, h0 = crapwow(seed, key), stride
  y0 = key + seed, then h += y; y += i+1, all mod the probed size
  (add_generic/contains_generic, bloom_filter.c:73-111);
- basic variant: the k probes spread over one m-bit bitmap;
- blocked variant: block = crc32c(seed, key) mod nblocks, the k probes
  confined to that B-bit block (bloom_filter.c:125-141).

A filter is m/32 words, bit j of word w being filter bit 32w + j, held as
int32 (the JAX package's uint32 words, reinterpreted).  ``build_bitmap`` and
``probe_bitmap`` are the in-graph pair (the JAX package's
``build_bitmap_xla``/``probe_bitmap_xla``): the build launches the CUDA
kernel of ``csrc/bloom.cu`` for keys on the card and runs its plain twin
``build_bitmap_plain`` for keys on the CPU; the probe is plain torch on any
device.  The ``*_host`` pair returns numpy for validation and the FPR
harness.  The plain functions work through the keys in slabs of SLAB_KEYS,
so a 1.024B-key probe side never holds more than a slab's int64
temporaries.
"""

from __future__ import annotations

import numpy as np
import torch

from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import hashes
from hwbloomradixjoin_tpu_torch.ops import u32 as U

SLAB_KEYS = 1 << 26          # keys a slab: 512 MiB per int64 temporary
PACK_SLAB_WORDS = 1 << 22    # filter words packed at once: 128 MiB of bits


def probe_positions(keys, seed: int, size: int, k: int):
    """The k probe bit positions of each key in a `size`-bit space (size a
    power of two: m for basic, B for blocked); a list of int64 tensors."""
    mask = size - 1
    h = hashes.hash_crapwow(seed, keys) & mask
    y = (U.u32(keys) + (seed & U.MASK32)) & mask
    out = []
    for i in range(k):
        if i:                      # step i: h += y_{i-1}; y_i = y_{i-1} + i
            h = (h + y) & mask
            y = (y + i) & mask
        out.append(h)
    return out


def block_index(keys, seed: int, nblocks: int) -> torch.Tensor:
    """Blocked-variant block selector: crc32c(seed, key) mod nblocks."""
    return hashes.hash_crc(seed, keys) & (nblocks - 1)


def global_positions(keys, args: BloomArgs):
    """Absolute bit positions in the m-bit filter of each of the k probes."""
    if args.variant == BloomVariant.BASIC:
        return probe_positions(keys, args.seed, args.m, args.k)
    base = block_index(keys, args.seed, args.nblocks) * args.B
    return [base + p for p in probe_positions(keys, args.seed, args.B,
                                              args.k)]


def _slabs(keys: torch.Tensor):
    keys = keys.reshape(-1)
    for i in range(0, keys.numel(), SLAB_KEYS):
        yield i, keys[i:i + SLAB_KEYS]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool (32n,) -> int32 (n,): bit j of word w is bits[32w + j].

    Packs 8 bits to a byte (distinct powers of two: the uint8 sum is
    exact) and reads each 4 bytes as one little-endian word.
    """
    nbytes = bits.numel() // 8
    packed = torch.empty(nbytes, dtype=torch.uint8, device=bits.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    raw = bits.view(torch.uint8)
    for b0 in range(0, nbytes, 4 * PACK_SLAB_WORDS):
        b1 = min(b0 + 4 * PACK_SLAB_WORDS, nbytes)
        packed[b0:b1] = (raw[8 * b0:8 * b1].view(-1, 8) << shifts).sum(
            1, dtype=torch.uint8)
    return packed.view(torch.int32)


def build_bitmap(keys: torch.Tensor, args: BloomArgs) -> torch.Tensor:
    """The filter of `keys` (any shape, PAD included) as (m/32,) int32
    words, on keys' device.

    Keys on the card (contiguous int32) go to the kernel hbrj_bloom_build
    (csrc/bloom.cu): the words are zeroed here and the kernel sets each
    probe's bit with an atomicOr, one launch for each L2-sized section of
    the words.  Keys on the CPU go to build_bitmap_plain; any other input
    raises.
    """
    if keys.device.type == "cpu":
        return build_bitmap_plain(keys, args)
    if keys.device.type != "cuda":
        raise ValueError(f"filter build given keys on {keys.device}")
    if keys.dtype != torch.int32 or not keys.is_contiguous():
        raise ValueError(f"filter build needs contiguous int32 keys, got "
                         f"{keys.dtype}, contiguous={keys.is_contiguous()}")
    if args.m % 32:
        raise ValueError(f"m = {args.m}: the filter is whole 32-bit words")
    blocked = args.variant == BloomVariant.BLOCKED
    words = torch.zeros(args.m // 32, dtype=torch.int32, device=keys.device)
    _build.launch("bloom_build", "hbrj_bloom_build", keys.device,
                  keys.data_ptr(), keys.numel(), words.data_ptr(), args.m,
                  args.B if blocked else 0, int(blocked),
                  args.seed & U.MASK32, args.k)
    return words


def build_bitmap_plain(keys: torch.Tensor, args: BloomArgs) -> torch.Tensor:
    """Plain twin of build_bitmap, on any device.

    torch has no OR scatter: each probe position sets a bool (idempotent,
    so exact for any multiset) and the bits are packed 32 to a word.  The
    fill takes its value as an argument: an assigned True is a host tensor
    copied to the device, which waits for the device's queue.
    """
    bits = torch.zeros(args.m, dtype=torch.bool, device=keys.device)
    for _, slab in _slabs(keys):
        for pos in global_positions(slab, args):
            bits.index_fill_(0, pos, True)
    return pack_bits(bits)


def probe_bitmap(words: torch.Tensor, keys: torch.Tensor,
                 args: BloomArgs) -> torch.Tensor:
    """contains() of each key against a filter: bool, keys' shape."""
    flat = words.reshape(-1)
    ok = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    ok_flat = ok.view(-1)
    for i, slab in _slabs(keys):
        hit = torch.ones(slab.shape, dtype=torch.bool, device=keys.device)
        for pos in global_positions(slab, args):
            hit &= ((flat[pos >> 5] >> (pos & 31).int()) & 1).bool()
        ok_flat[i:i + slab.numel()] = hit
    return ok


def build_bitmap_host(keys: np.ndarray, args: BloomArgs) -> np.ndarray:
    """The filter as uint32 words (m/32), in numpy."""
    words = build_bitmap(torch.from_numpy(np.ascontiguousarray(
        keys, dtype=np.int32)), args)
    return words.numpy().view(np.uint32)


def probe_bitmap_host(bitmap: np.ndarray, keys: np.ndarray,
                      args: BloomArgs) -> np.ndarray:
    """contains() of each key against uint32 words, in numpy."""
    words = np.ascontiguousarray(bitmap).view(np.int32)
    if not words.flags.writeable:          # torch wants writable memory
        words = words.copy()
    words = torch.from_numpy(words)
    return probe_bitmap(words, torch.from_numpy(np.ascontiguousarray(
        keys, dtype=np.int32)), args).numpy()


def theoretical_fpr(m: int, k: int, n: int) -> float:
    """FPR = (1 - (1 - 1/m)^(k n))^k (unit_tests.c:231-232)."""
    return (1.0 - (1.0 - 1.0 / m) ** (k * n)) ** k
