"""uint32 / uint64 arithmetic on torch int64 tensors holding uint32 values.

Counterpart of ``hwbloomradixjoin_tpu/ops/u32.py``.  torch has no uint32
arithmetic, so a uint32 value rides in an int64 tensor, in [0, 2^32), and
every function masks its result back to 32 bits.  Products are split so no
intermediate leaves int64's range: a 32 x 16-bit product is below 2^48.
uint64 values are (hi, lo) pairs of such tensors, as in the JAX package.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def u32(x) -> torch.Tensor:
    """int32 (two's complement) or int64 values -> int64 in [0, 2^32)."""
    return torch.as_tensor(x).long() & MASK32


def mul_lo(a, b) -> torch.Tensor:
    """Low 32 bits of a*b."""
    a, b = u32(a), u32(b)
    return (a * (b & _MASK16) + (((a * (b >> 16)) & _MASK16) << 16)) & MASK32


def mul_hi(a, b) -> torch.Tensor:
    """High 32 bits of the 64-bit product a*b.

    a*b = p_hi * 2^16 + p_lo with p_lo = a*(b & 0xFFFF), p_hi = a*(b >> 16),
    both below 2^48, so (a*b) >> 32 = (p_hi + (p_lo >> 16)) >> 16.
    """
    a, b = u32(a), u32(b)
    return (a * (b >> 16) + ((a * (b & _MASK16)) >> 16)) >> 16


def mul_wide(a, b):
    """Full 64-bit product as a (hi, lo) pair."""
    return mul_hi(a, b), mul_lo(a, b)


def rotl32(x, r: int) -> torch.Tensor:
    x = u32(x)
    r = int(r) & 31
    if r == 0:
        return x
    return ((x << r) | (x >> (32 - r))) & MASK32


def u64_add(ah, al, bh, bl):
    lo = u32(al) + u32(bl)
    hi = (u32(ah) + u32(bh) + (lo >> 32)) & MASK32
    return hi, lo & MASK32


def u64_xor(ah, al, bh, bl):
    return u32(ah) ^ u32(bh), u32(al) ^ u32(bl)


def u64_rotl(ah, al, r: int):
    """Rotate a 64-bit (hi, lo) pair left by r."""
    r = int(r) & 63
    ah, al = u32(ah), u32(al)
    if r == 0:
        return ah, al
    if r == 32:
        return al, ah
    if r > 32:
        ah, al, r = al, ah, r - 32
    hi = ((ah << r) | (al >> (32 - r))) & MASK32
    lo = ((al << r) | (ah >> (32 - r))) & MASK32
    return hi, lo


def sign_extend_byte(b) -> torch.Tensor:
    """The low 8 bits of b as a signed char, widened to uint32 (the
    reference's byte loops mix bytes >= 0x80 sign-extended)."""
    b = u32(b) & 0xFF
    return torch.where(b >= 0x80, b | 0xFFFFFF00, b)
