"""The bloom filter's hash functions and probe positions, frozen here.

The reference suite's filter (``src/bloom_filter.c``, ``src/hash.c``):

- the k probe positions of a key in a `size`-bit space come from enhanced
  double hashing: h = crapwow(seed, key) mod size, y = (key + seed) mod
  size, then for i = 1 .. k-1: h += y, y += i, all mod size
  (``add_generic`` / ``contains_generic``, bloom_filter.c:73-111);
- the basic filter probes the whole m-bit space; the blocked filter first
  picks the block crc32c(seed, key) mod (m / B) and probes inside its B
  bits (bloom_filter.c:125-141).

The benchmark's reference uses this copy, so a change to the program's
hashes shows as wrong survivors rather than changing the yardstick with
it.  Keys are integer tensors; their low 32 bits are hashed as uint32
values held in int64.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
CRAPWOW_M = 0x5052ACDB
CRC32C_POLY = 0x82F63B78          # reflected Castagnoli polynomial


def _crc32c_byte_table() -> list[int]:
    table = []
    for i in range(256):
        x = i
        for _ in range(8):
            x = (x >> 1) ^ (CRC32C_POLY if x & 1 else 0)
        table.append(x)
    return table


CRC32C_BYTE_TABLE = _crc32c_byte_table()


def u32(keys: torch.Tensor) -> torch.Tensor:
    return keys.long() & MASK32


def crc32c(seed: int, keys: torch.Tensor) -> torch.Tensor:
    """_mm_crc32_u32(seed, key): four reflected byte steps, no inversion."""
    table = torch.tensor(CRC32C_BYTE_TABLE, dtype=torch.int64,
                         device=keys.device)
    x = u32(keys) ^ (seed & MASK32)
    for _ in range(4):
        x = (x >> 8) ^ table[x & 0xFF]
    return x


def crapwow(seed: int, keys: torch.Tensor) -> torch.Tensor:
    """CrapWow over one 4-byte key (src/hash.c's cwmixb / cwfold): every
    product of a uint32 and CRAPWOW_M (< 2^31) fits in int64."""
    p = u32(keys) * CRAPWOW_M
    h = (p & MASK32) ^ 4
    k = (p >> 32) ^ ((seed + 4 + CRAPWOW_M) & MASK32)
    p = (h ^ ((k + CRAPWOW_M) & MASK32)) * CRAPWOW_M
    return (k ^ (p >> 32)) ^ (h ^ (p & MASK32))


def probes(keys: torch.Tensor, seed: int, size: int, k: int):
    """The k probe positions of each key in a `size`-bit space (a power of
    two), as int64 tensors."""
    mask = size - 1
    h = crapwow(seed, keys) & mask
    y = (u32(keys) + (seed & MASK32)) & mask
    out = [h]
    for i in range(1, k):
        h = (h + y) & mask
        y = (y + i) & mask
        out.append(h)
    return out


def positions(keys: torch.Tensor, filt: dict):
    """The absolute bit positions of each key's k probes in the m-bit
    filter `filt` (variant, m, k, B, seed)."""
    seed, m, k = filt["seed"], filt["m"], filt["k"]
    if filt["variant"] == "basic":
        return probes(keys, seed, m, k)
    B = filt["B"]
    base = (crc32c(seed, keys) & (m // B - 1)) * B
    return [base + p for p in probes(keys, seed, B, k)]
